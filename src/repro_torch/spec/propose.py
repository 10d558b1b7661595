"""Draft proposers: who guesses the k candidate tokens (twin of
``repro.spec.propose``).

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
    target uses. Greedy requests draft the device argmax; sampled ones
    draw from the draft's own distribution with the request's keyed
    stream (salted by ``sampler.DRAFT_SALT``) and hand the distributions
    to the exact accept rule.

Proposers see the engine through ``attach`` / ``on_admit`` /
``on_prefill_chunk`` / ``on_retire`` / ``on_preempt`` / ``on_restore`` /
``propose`` / ``sync``; the engine calls ``propose`` only for slots
that finished prefill.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models import api, paged
from repro_torch.spec import sampler


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
        qdists[i] is the [ks[i], V] proposal distributions, or None for
        a point mass on each draft (greedy drafting, n-gram lookup)."""
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
    Greedy drafts are the device argmax of each draft step (ties to the
    lower token id, as ``np.argmax``); a batch of greedy requests moves
    one [k_max, B] tensor of token ids to the host per engine step. A
    step with sampled requests pulls their draft rows to the host at
    each draft step, as the reference does: the draw is a host rule over
    float64 (``sampler.target_dist`` and its inverse CDF)."""

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
        """Draft steps: the device argmax for every slot; a sampled
        request's token is then replaced by a keyed draw from the draft's
        distribution at emit index ``len(output) + j``, on its row pulled
        to the host. An all-greedy batch makes one [k_max, B] transfer."""
        k_max = max(ks) if ks else 0
        keep = torch.ones(self.max_slots, dtype=torch.bool,
                          device=self.device)
        keep[[r.slot for r in reqs]] = False
        saved = paged.save_slots(self.caches, keep)
        toks = torch.zeros((self.max_slots, 1), dtype=torch.int32)
        for r in reqs:
            toks[r.slot, 0] = int(r.output[-1])
        toks = toks.to(self.device)
        drawn = [(i, r) for i, r in enumerate(reqs) if r.temperature > 0.0]
        rows_idx = torch.tensor([r.slot for _, r in drawn],
                                dtype=torch.long, device=self.device)
        qrows = [[] for _ in reqs]
        picks = []
        for j in range(k_max + 1):
            logits = self._decode(self.params, toks, self.caches)
            if j == k_max:
                break          # this step only appended the last draft's KV
            toks = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            if drawn:
                rows = logits[rows_idx].to(torch.float32).cpu().numpy()
                draws = []
                for n, (i, r) in enumerate(drawn):
                    q = sampler.target_dist(rows[n], r.temperature, r.top_k)
                    key = prng.fold_in(
                        sampler.emit_key(r.seed, len(r.output) + j),
                        sampler.DRAFT_SALT)
                    draws.append(sampler._inverse_cdf(q, sampler._uniform(key)))
                    if j < ks[i]:
                        qrows[i].append(q)
                toks[rows_idx, 0] = torch.tensor(draws, dtype=torch.int32,
                                                 device=self.device)
            picks.append(toks[:, 0])
        # the full-batch draft decode also stepped slots not drafted for
        # (mid-prefill or idle): give them back their lengths
        paged.keep_slots(self.caches, saved, keep)
        host = (torch.stack(picks).cpu().tolist() if picks
                else [])                                     # [k_max][B]
        drafts = [[host[j][r.slot] for j in range(k)]
                  for r, k in zip(reqs, ks)]
        return drafts, [np.stack(q) if q else None for q in qrows]

    def sync(self, reqs, new_lens) -> None:
        if not reqs:
            return
        paged.set_lens(
            self.caches,
            torch.tensor([r.slot for r in reqs], device=self.device),
            torch.tensor(new_lens, dtype=torch.int32, device=self.device))
