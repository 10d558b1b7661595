"""Draft proposers: who guesses the k candidate tokens (twin of
``repro.spec.propose``, greedy drafting).

``NGramProposer``
    Prompt-lookup decoding: no extra parameters, no extra launches. The
    request's trailing n-gram (prompt + emitted) is matched against its
    earlier history and the continuation of the most recent match is
    proposed; with no match it proposes padding, which verify rejects.

``DraftModelProposer``
    A model drafting for the target with its OWN paged KV cache that
    mirrors the target's sequences chunk by chunk. It costs k_max + 1
    batched draft decode steps per engine step (the last one appends the
    final draft's KV, so a fully accepted window leaves the mirror
    aligned); rollback is the same ``paged.set_lens`` bookkeeping the
    target uses.

Proposers see the engine through ``attach`` / ``on_admit`` /
``on_prefill_chunk`` / ``on_retire`` / ``on_preempt`` / ``on_restore`` /
``propose`` / ``sync``; the engine calls ``propose`` only for slots
that finished prefill. Sampled requests (temperature > 0) need the keyed
RNG of ROADMAP queue A item 4.
"""

from __future__ import annotations

import torch

from repro_torch.models import api, paged


def _sampled(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} drafts greedy requests only; sampled drafting waits for "
        "the keyed RNG (ROADMAP queue A item 4)")


class Proposer:
    """No-op base: the hook surface between a proposer and the engine."""

    name = "none"

    def attach(self, engine) -> None:
        """Called once by ``SpecDecodeEngine.__init__``."""

    def on_admit(self, req) -> None:
        """``req`` was admitted to a slot (tables reset, prefill next)."""

    def on_prefill_chunk(self, req, chunk: list, pos0: int) -> None:
        """The engine cached one prompt chunk for ``req``."""

    def on_retire(self, req) -> None:
        """``req`` left its slot; release any per-slot state."""

    def on_preempt(self, req) -> None:
        """``req`` was preempted (slot still valid): drop slot state."""
        self.on_retire(req)

    def on_restore(self, req) -> None:
        """``req`` came back after preemption; rebuild its mirror."""

    def propose(self, reqs: list, ks: list[int]
                ) -> tuple[list[list[int]], list]:
        """Draft ``ks[i]`` tokens for each decoding request. Returns
        (drafts, qdists): drafts[i] holds exactly ks[i] token ids;
        qdists[i] is None (a point-mass proposal: greedy drafting)."""
        raise NotImplementedError

    def sync(self, reqs: list, new_lens: list[int]) -> None:
        """Verification accepted a prefix; roll internal state to it."""


class NGramProposer(Proposer):
    """Prompt lookup: propose the continuation of the most recent earlier
    occurrence of the request's trailing n-gram (n = max_n..min_n)."""

    name = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1, pad_token: int = 0):
        if not max_n >= min_n >= 1:
            raise ValueError(f"need max_n >= min_n >= 1, got {max_n}, "
                             f"{min_n}")
        self.max_n = max_n
        self.min_n = min_n
        self.pad_token = pad_token

    def _lookup(self, hist: list[int], k: int) -> list[int]:
        for n in range(self.max_n, self.min_n - 1, -1):
            if len(hist) <= n:
                continue
            pattern = hist[-n:]
            # the most recent earlier occurrence wins
            for start in range(len(hist) - n - 1, -1, -1):
                if hist[start:start + n] == pattern:
                    cont = hist[start + n:start + n + k]
                    if cont:
                        return (cont + [self.pad_token] * (k - len(cont)))[:k]
        return [self.pad_token] * k

    def propose(self, reqs, ks):
        drafts = [self._lookup(list(r.prompt) + list(r.output), k)
                  for r, k in zip(reqs, ks)]
        return drafts, [None] * len(reqs)


class DraftModelProposer(Proposer):
    """A draft model with its own paged KV cache on the engine's device.

    The mirror replays prompt chunks as the engine caches them, is synced
    to accepted prefixes by the target's length rollback, and its
    (k_max + 1)-th decode step appends the final draft's KV. Slot s owns
    row s of an identity table, so the draft pool needs no allocator.
    Drafts are the device argmax of each draft step (ties to the lower
    token id, as ``np.argmax``); one [k_max, B] tensor of token ids
    reaches the host per engine step."""

    name = "draft"

    def __init__(self, cfg, params):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"draft model must be a paged-KV attention family "
                f"(rollback is a length decrement), got {cfg.family!r}")
        self.cfg = cfg
        self.params = params
        self.engine = None

    def attach(self, engine) -> None:
        if self.cfg.vocab_size != engine.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {self.cfg.vocab_size} != target vocab "
                f"{engine.cfg.vocab_size}: draft tokens must be target "
                f"tokens")
        self.engine = engine
        self.device = engine.device
        self.max_slots = engine.max_slots
        layout = engine.layout
        self.params = api.to_device(self.params, self.device)
        self.kv = api.KVCache.build(self.cfg,
                                    max_context=layout.max_context,
                                    block_size=layout.block_size,
                                    max_slots=engine.max_slots)
        self.token_bytes = self.kv.token_bytes(engine.max_slots)
        self.caches = self.kv.init(engine.max_slots, self.device)
        self._decode = api.decode_fn(self.cfg)
        self._chunk = api.prefill_chunk_fn(self.cfg)
        self._identity = paged.identity_table(engine.max_slots, layout,
                                              device=self.device)
        self._null_row = torch.full((layout.max_blocks,), paged.NULL_BLOCK,
                                    dtype=torch.int32, device=self.device)
        self._chunk_size = engine.scheduler.prefill_chunk

    def _replay(self, req, hist: list) -> None:
        """Rebuild ``req``'s mirror from tokens alone, through the same
        chunked prefill path."""
        paged.reset_slot(self.caches, req.slot,
                               self._identity[req.slot])
        pos = 0
        while pos < len(hist):
            end = min(pos + self._chunk_size, len(hist))
            self.on_prefill_chunk(req, hist[pos:end], pos)
            pos = end

    def on_admit(self, req) -> None:
        # prefill starts at req.prefill_pos: a span the target already
        # holds (a prefix-cache hit) is replayed, the engine's own chunks
        # deliver the rest
        self._replay(req, list(req.prompt[:req.prefill_pos]))

    def on_prefill_chunk(self, req, chunk, pos0) -> None:
        tok = torch.tensor([list(chunk)], dtype=torch.int32,
                           device=self.device)
        self._chunk(self.params, tok, self.caches, req.slot, pos0)

    def on_retire(self, req) -> None:
        paged.reset_slot(self.caches, req.slot, self._null_row)

    def on_restore(self, req) -> None:
        # the mirror was torn down at preemption: replay the prompt and
        # every emitted token but the pending last one
        self._replay(req, list(req.prompt)
                     + [int(t) for t in req.output[:-1]])

    def propose(self, reqs, ks):
        for r in reqs:
            if r.temperature > 0.0:
                raise _sampled("DraftModelProposer")
        k_max = max(ks) if ks else 0
        old_len = self.caches["len"].clone()
        toks = torch.zeros((self.max_slots, 1), dtype=torch.int32)
        for r in reqs:
            toks[r.slot, 0] = int(r.output[-1])
        toks = toks.to(self.device)
        picks = []
        for j in range(k_max + 1):
            logits = self._decode(self.params, toks, self.caches)
            if j == k_max:
                break          # this step only appended the last draft's KV
            toks = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            picks.append(toks[:, 0])
        # the full-batch draft decode also stepped slots not drafted for
        # (mid-prefill or idle): give them back their lengths
        keep = torch.ones(self.max_slots, dtype=torch.bool)
        keep[[r.slot for r in reqs]] = False
        paged.keep_slots(self.caches, old_len, keep.to(self.device))
        host = (torch.stack(picks).cpu().tolist() if picks
                else [])                                     # [k_max][B]
        drafts = [[host[j][r.slot] for j in range(k)]
                  for r, k in zip(reqs, ks)]
        return drafts, [None] * len(reqs)

    def sync(self, reqs, new_lens) -> None:
        if not reqs:
            return
        paged.set_lens(
            self.caches,
            torch.tensor([r.slot for r in reqs], device=self.device),
            torch.tensor(new_lens, dtype=torch.int32, device=self.device))
