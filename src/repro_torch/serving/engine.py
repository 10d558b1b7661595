"""Paged-KV continuous-batching serving engines (the core of
``repro.serving.engine``).

``BlockAllocator``
    Reference-counted free list over the shared per-layer KV block pools;
    block 0 is the reserved null block.
``Scheduler``
    FIFO admission (requests wait while the slot or block pool is full;
    head-of-line blocking keeps admission order = submission order) and
    chunked prefill, ONE chunk per engine step, interleaved with the
    batched decode step.
``DecodeEngine``
    Owns the parameters and the device cache tree and drives the
    scheduler. Each decode step is one model step for every slot, then
    the greedy choice and the fused ``_logit_stats`` pass (two calls
    of the compensated row-reduction kernel on the card), packed into
    one [7, B] f32 tensor that crosses to the host once.
``SpecDecodeEngine``
    Replaces the decode step by draft -> verify -> accept: a proposer
    (``repro_torch.spec``) drafts up to ``spec_k`` tokens per decoding
    slot, ONE ``verify_fn`` pass scores every slot's window against the
    paged KV, and the greedy accept rule emits 1 to k + 1 tokens per
    slot, the non-speculative stream.

Determinism: greedy argmax by default; a request's chunk boundaries and
decode math depend only on its own prompt and the cache geometry, so
batched serving matches solo generation token for token. Requests can
opt into temperature + top-k sampling with a per-request ``seed``: the
draw is keyed on (seed, tokens emitted) only (``repro_torch.core.prng``,
bitwise jax's threefry), so it too is independent of batch composition
and admission timing.

Lifecycle and faults: requests carry ``deadline_steps`` and can be
cancelled anywhere with slot, blocks and proposer mirror state released;
a ``NumericsGuard`` quarantines a slot whose logits go non-finite or
whose round-off explodes; a keyed ``FaultInjector``
(``repro_torch.serving.faults``) NaNs logit rows, poisons KV blocks,
fails allocations and stalls proposers at replayable steps, and
``FailoverServer`` retries quarantined requests on a degraded engine.
Prefix caching, session KV, preemption and telemetry are later slices
of the port; their constructor knobs raise ``NotImplementedError``
naming the ROADMAP item.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.models import api, paged
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import NULL_BLOCK, PagedLayout
from repro_torch.serving.faults import (AdmissionError, AllocatorError,
                                        NumericsGuard, ProposerStallError,
                                        StallError)

DEFAULT_BLOCK_SIZE = paged.DEFAULT_BLOCK_SIZE


def _later(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue A item {item})")


@dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    eos_id: int | None = None
    # sampling: temperature == 0 is greedy; top_k == 0 means the whole
    # vocabulary; ``seed`` keys the request's private stream (folded with
    # the emit index, so a draw does not depend on the batch)
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    # speculative decoding: None inherits the engine's spec_k; the engine
    # also caps it by the window, the token budget and the slot's blocks
    spec_k: int | None = None
    # lifecycle: a deadline in engine steps from submission (None: none);
    # ``priority`` feeds the "priority" preemption policy, which is not
    # ported: ``submit`` refuses any other value than 0. ``state`` walks queued -> prefilling -> decoding -> done |
    # cancelled | expired | quarantined | failed
    deadline_steps: int | None = None
    priority: int = 0
    output: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)   # per emitted token
    slot: int | None = None
    done: bool = False
    prefill_pos: int = 0                           # prompt tokens cached
    blocks: list = field(default_factory=list)     # pool blocks referenced
    state: str = "queued"
    error: str | None = None
    submit_step: int = 0
    last_progress_step: int = 0
    retries: int = 0

    @property
    def num_cached(self) -> int:
        """Tokens currently occupying KV positions (prompt + emitted)."""
        return self.prefill_pos + len(self.output)

    def reset_for_retry(self) -> None:
        """Scrub per-run state so the request can be resubmitted (the
        ``FailoverServer``'s degraded-tier retry)."""
        if self.slot is not None or self.blocks:
            raise RuntimeError(f"request {self.rid} still holds engine "
                               f"resources")
        self.output = []
        self.logprobs = []
        self.done = False
        self.prefill_pos = 0
        self.state = "queued"
        self.retries += 1


class BlockAllocator:
    """Reference-counted LIFO free list over a ``num_blocks`` pool; block
    0 stays reserved. Misuse raises ``AllocatorError``. ``fail_next``
    (armed by a ``FaultInjector``) makes the next ``alloc`` raise once:
    a transient failure the admission path absorbs."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("pool needs the null block plus capacity")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, NULL_BLOCK, -1))
        self._ref: dict[int, int] = {}
        self.fail_next = False
        self.faults = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_held(self) -> int:
        return len(self._ref)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> list[int]:
        if self.fail_next:
            self.fail_next = False
            self.faults += 1
            raise AllocatorError("injected allocation failure")
        if n > len(self._free):
            raise AllocatorError(f"block pool exhausted: want {n}, "
                                 f"have {len(self._free)}")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        return blocks

    def retain(self, blocks: list[int]) -> None:
        for b in blocks:
            if b not in self._ref:
                raise AllocatorError(f"retain of free block {b}")
            self._ref[b] += 1

    def release(self, blocks: list[int]) -> None:
        for b in blocks:
            if b not in self._ref:
                raise AllocatorError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)


class Scheduler:
    """FIFO admission + slot assignment + chunked-prefill bookkeeping."""

    def __init__(self, allocator: BlockAllocator, max_slots: int,
                 layout: PagedLayout, prefill_chunk: int):
        self.allocator = allocator
        self.layout = layout
        self.prefill_chunk = prefill_chunk
        self.waiting: deque[Request] = deque()
        self.prefilling: deque[Request] = deque()
        self.decoding: dict[int, Request] = {}
        self._free_slots = list(range(max_slots))

    def submit(self, req: Request) -> None:
        need = len(req.prompt) + req.max_new_tokens
        if need > self.layout.max_context:
            raise AdmissionError(
                f"request {req.rid}: prompt+max_new = {need} exceeds "
                f"max_context {self.layout.max_context}")
        usable = self.allocator.num_blocks - 1
        if self.blocks_needed(req) > usable:
            raise AdmissionError(
                f"request {req.rid}: needs {self.blocks_needed(req)} blocks "
                f"but the pool only has {usable}")
        if req.deadline_steps is not None and req.deadline_steps < 1:
            raise AdmissionError(
                f"request {req.rid}: deadline_steps must be >= 1, "
                f"got {req.deadline_steps}")
        req.state = "queued"
        self.waiting.append(req)

    def blocks_needed(self, req: Request) -> int:
        return self.layout.blocks_for(len(req.prompt) + req.max_new_tokens)

    def admit(self) -> list[Request]:
        """Move waiting requests into slots while capacity lasts; the
        queue head blocks (no skip-ahead)."""
        admitted = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            need = self.blocks_needed(req)
            if need > self.allocator.num_free:
                break
            try:
                req.blocks = self.allocator.alloc(need)
            except AllocatorError:
                break          # a transient failure: the head waits

            req.prefill_pos = 0
            self.waiting.popleft()
            req.slot = self._free_slots.pop()
            req.state = "prefilling"
            self.prefilling.append(req)
            admitted.append(req)
        return admitted

    def next_chunk(self) -> tuple[Request, list, int] | None:
        """The head prefilling request's next chunk (req, tokens, pos0)."""
        if not self.prefilling:
            return None
        req = self.prefilling[0]
        pos0 = req.prefill_pos
        return req, req.prompt[pos0:pos0 + self.prefill_chunk], pos0

    def prefill_advance(self, req: Request, n: int) -> bool:
        """Record ``n`` freshly cached prompt tokens; True when complete."""
        req.prefill_pos += n
        if req.prefill_pos == len(req.prompt):
            self.prefilling.popleft()
            return True
        return False

    def start_decoding(self, req: Request) -> None:
        req.state = "decoding"
        self.decoding[req.slot] = req

    def _release(self, req: Request) -> None:
        self.allocator.release(req.blocks)
        req.blocks = []
        self._free_slots.append(req.slot)

    def drop(self, req: Request, state: str) -> bool:
        """Remove ``req`` from whichever queue holds it (cancellation,
        expiry, quarantine), releasing its slot and blocks. False if the
        request is not in flight. The engine resets the slot's table."""
        if req in self.waiting:
            self.waiting.remove(req)
        elif req.slot is not None and (req in self.prefilling
                                       or self.decoding.get(req.slot) is req):
            if req in self.prefilling:
                self.prefilling.remove(req)
            self.decoding.pop(req.slot, None)
            self._release(req)
        else:
            return False
        req.state = state
        return True

    def retire(self, req: Request) -> None:
        req.done = True
        req.state = "done"
        self.decoding.pop(req.slot, None)
        self._release(req)

    @property
    def num_unfinished(self) -> int:
        return (len(self.waiting) + len(self.prefilling)
                + len(self.decoding))


def _logit_stats(logits: torch.Tensor, tokens: torch.Tensor) -> dict:
    """Per-row logit statistics in two calls of the fused reduction:
    running max + compensated sum and sum of squares, then the
    compensated exp-sum for logsumexp = m + log sum e^(l - m).

    ``round_off`` is the numerics guard's detector: the relative
    deviation between the compensated row sum and a naive f32 sum of the
    same row (``torch.sum``; a tree reduction on the card, so healthy
    rows read lower there than on a CPU)."""
    l32 = logits.to(torch.float32)
    st = ops.batched_fused_reduce(l32, outputs=("max", "sum", "sumsq"))
    sumexp = ops.batched_fused_reduce(
        torch.exp(l32 - st["max"][:, None]), outputs=("sum",))["sum"]
    lse = st["max"] + torch.log(sumexp)
    chosen = torch.gather(l32, 1, tokens.to(torch.int64)[:, None])[:, 0]
    vocab = logits.shape[-1]
    naive = torch.sum(l32, dim=-1)
    return {"logprob": chosen - lse, "logsumexp": lse, "max": st["max"],
            "mean": st["sum"] / vocab,
            "rms": torch.sqrt(st["sumsq"] / vocab),
            "round_off": torch.abs(st["sum"] - naive)
            / (torch.abs(st["sum"]) + 1.0)}


def _greedy_tokens(rows: torch.Tensor) -> torch.Tensor:
    return torch.argmax(rows, dim=-1).to(torch.int32)


# host-transfer order of the decode step's packed stats rows
_STAT_KEYS = ("logprob", "logsumexp", "max", "mean", "rms", "round_off")


def _pack(tokens: torch.Tensor, stats: dict) -> torch.Tensor:
    """[1 + 6, B] f32: token ids (exact in f32, vocab << 2^24) + stats."""
    return torch.stack([tokens.to(torch.float32)]
                       + [stats[k] for k in _STAT_KEYS])


def _sample_rows(rows: torch.Tensor, temperatures: torch.Tensor,
                 keys: torch.Tensor, top_k: int) -> torch.Tensor:
    """Temperature + top-k draws for rows that share a ``top_k`` (the
    reference's ``_sample_row`` mapped over the rows): rows [S, V],
    temperatures [S] f32, keys [S, 2] -> tokens [S] (int64), on the
    rows' device. Each row is ``jax.random.categorical`` of its own
    key over ``row / max(t, 1e-6)``; with ``top_k`` the logits below the
    k-th largest become -inf, so values tied with it are kept (as
    ``jax.lax.top_k`` + ``where(logits < kth)``). A ``top_k`` past the
    vocabulary means no truncation."""
    logits = rows.to(torch.float32) / torch.clamp_min(temperatures,
                                                      1e-6)[:, None]
    if top_k:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]),
                         dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    return prng.categorical(keys, logits)


class DecodeEngine:
    """Paged continuous-batching engine over a fixed slot pool.

    ``params`` is the port's parameter tree (``api.init_params`` or
    ``bridge.params_from_reference``); it is moved to ``device``, which
    defaults to the GPU (``None`` -> ``cuda``, raising without one).
    ``num_blocks`` sets the shared pool size per layer (default: every
    slot can hold ``max_context``); a smaller pool oversubscribes and
    admission waits for real availability.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_context: int = 256,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 num_blocks: int | None = None, prefill_chunk: int = 32,
                 prefix_cache: bool = False, spill_blocks: int = 0,
                 preempt: str = "off",
                 guard: NumericsGuard | None = NumericsGuard(),
                 fault_injector=None, telemetry=None, device=None):
        self.device = _device.resolve(device)
        if prefix_cache or spill_blocks:
            raise _later("prefix caching / session KV / spill", 7)
        if preempt != "off":
            raise _later("preemption to host", 7)
        if telemetry is not None:
            raise _later("telemetry", 9)
        if self.device.type == "cuda":
            _device.set_numerics()
        self.cfg = cfg
        self.params = api.to_device(params, self.device)
        self.max_slots = max_slots
        self.kv = api.KVCache.build(cfg, max_context=max_context,
                                    block_size=block_size,
                                    max_slots=max_slots,
                                    num_blocks=num_blocks)
        self.layout = self.kv.layout
        self.scheduler = Scheduler(BlockAllocator(self.kv.num_blocks),
                                   max_slots, self.layout, prefill_chunk)
        self.guard = guard
        self.injector = fault_injector
        self.quarantined: list[Request] = []
        self._step_count = 0
        self._prefill_chunk = api.prefill_chunk_fn(cfg)   # raises for a
        self._decode = api.decode_fn(cfg)                 # family not served
        self.caches = self.kv.init(max_slots, self.device)
        # host-side next tokens, uploaded once per decode step
        self._next_tokens = np.zeros((max_slots, 1), np.int32)
        self._null_row = torch.full((self.layout.max_blocks,), NULL_BLOCK,
                                    dtype=torch.int32, device=self.device)
        # KV traffic accounting: the bytes each layout must address per
        # step (paged: the slot's blocks; contiguous: a max_context row)
        self._token_bytes = self.kv.token_bytes(max_slots)
        self._token_bytes_bf16 = api.KVCache.build(
            cfg.with_(kv_dtype="bf16"), max_context=max_context,
            block_size=block_size, max_slots=max_slots,
            num_blocks=num_blocks).token_bytes(max_slots)
        self.kv_stats = {"paged_bytes": 0, "paged_bytes_bf16": 0,
                         "contiguous_bytes": 0, "decode_steps": 0,
                         "prefill_chunks": 0, "prefill_tokens": 0,
                         "guard_trips": 0, "cancelled": 0, "expired": 0,
                         "alloc_faults": 0, "stalled_requests": 0}
        self.last_logit_stats: dict | None = None

    # ------------------------------------------------------------ API -----

    def submit(self, req: Request) -> None:
        """Enqueue a request; raises ``AdmissionError`` for requests that
        could never run (context or pool overflow, bad deadline)."""
        if req.priority != 0:
            raise _later("Request.priority (preemption)", 7)
        req.submit_step = self._step_count
        req.last_progress_step = self._step_count
        self.scheduler.submit(req)

    def step(self) -> None:
        """One engine step: expire deadlines, inject the step's faults,
        admit, run at most one prefill chunk, then one batched decode step
        for every decoding slot."""
        self._step_count += 1
        self._expire_deadlines()
        if self.injector is not None:
            self._inject_step_faults()
        for req in self.scheduler.admit():
            row = torch.full((self.layout.max_blocks,), NULL_BLOCK,
                             dtype=torch.int32)
            row[:len(req.blocks)] = torch.as_tensor(req.blocks)
            paged.reset_slot(self.caches, req.slot, row.to(self.device))
            self._on_admit(req)
        nxt = self.scheduler.next_chunk()
        if nxt is not None:
            req, chunk, pos0 = nxt
            tok = torch.tensor([chunk], dtype=torch.int32, device=self.device)
            logits = self._prefill_chunk(self.params, tok, self.caches,
                                         req.slot, pos0)
            self._on_prefill_chunk(req, chunk, pos0)
            req.last_progress_step = self._step_count
            self.kv_stats["prefill_tokens"] += len(chunk)
            self._account_prefill(pos0 + len(chunk), first=pos0 == 0)
            if self.scheduler.prefill_advance(req, len(chunk)):
                self._emit_first_token(req, logits)
        if self.scheduler.decoding:
            self._decode_step()
        self.kv_stats["alloc_faults"] = self.scheduler.allocator.faults

    # Subclass hooks (the speculative engine mirrors them into its
    # proposer). Preemption is not ported, so nothing calls the preempt /
    # restore pair yet.
    def _on_admit(self, req: Request) -> None:
        pass

    def _on_prefill_chunk(self, req: Request, chunk: list,
                          pos0: int) -> None:
        pass

    def _on_retire(self, req: Request) -> None:
        pass

    def _on_preempt(self, req: Request) -> None:
        pass

    def _on_restore(self, req: Request) -> None:
        pass

    def _on_drop(self, req: Request) -> None:
        """A slot-holding request leaves abnormally (cancelled, expired,
        quarantined); ``req.slot`` is still valid."""

    def run_until_done(self, max_steps: int = 10_000) -> None:
        """Drive steps until every request finishes; raises
        ``StallError`` with per-request diagnostics after ``max_steps``."""
        for _ in range(max_steps):
            if not self.scheduler.num_unfinished:
                return
            self.step()
        if self.scheduler.num_unfinished:
            diags = self.request_diagnostics()
            self.kv_stats["stalled_requests"] = len(diags)
            raise StallError(f"{len(diags)} requests unfinished after "
                             f"{max_steps} steps", diags)

    def request_diagnostics(self) -> list[dict]:
        sched = self.scheduler
        out = []
        for state, reqs in (("waiting", sched.waiting),
                            ("prefilling", sched.prefilling),
                            ("decoding", sched.decoding.values())):
            for req in reqs:
                out.append({"rid": req.rid, "state": state,
                            "slot": req.slot,
                            "blocks_held": len(req.blocks),
                            "prefill_pos": req.prefill_pos,
                            "emitted": len(req.output),
                            "steps_since_progress":
                                self._step_count - req.last_progress_step})
        return out

    @property
    def num_unfinished(self) -> int:
        return self.scheduler.num_unfinished

    # ----------------------------------------------- lifecycle control ----

    def _in_flight(self) -> list[Request]:
        sched = self.scheduler
        return (list(sched.waiting) + list(sched.prefilling)
                + list(sched.decoding.values()))

    def cancel(self, rid: int) -> bool:
        """Cancel an in-flight request wherever it is (waiting,
        prefilling, decoding), releasing its slot, blocks and proposer
        mirror state. False if no such request is in flight."""
        for req in self._in_flight():
            if req.rid == rid:
                return self._terminate(req, "cancelled")
        return False

    def cancel_all(self) -> int:
        """Cancel everything in flight; returns how many were cancelled."""
        return sum(self._terminate(r, "cancelled")
                   for r in self._in_flight())

    def _expire_deadlines(self) -> None:
        for req in self._in_flight():
            if (req.deadline_steps is not None
                    and self._step_count - req.submit_step
                    > req.deadline_steps):
                self._terminate(req, "expired")

    def _terminate(self, req: Request, state: str) -> bool:
        sched = self.scheduler
        slot = req.slot
        active = slot is not None and (req in sched.prefilling
                                       or sched.decoding.get(slot) is req)
        if active:
            self._on_drop(req)         # the mirror needs the slot still
        if not sched.drop(req, state):
            return False
        if active:
            paged.reset_slot(self.caches, slot, self._null_row)
            req.slot = None
        self.kv_stats[state] += 1
        return True

    # -------------------------------------------- faults & quarantine -----

    def _inject_step_faults(self) -> None:
        """Step sites: poison a decoding victim's KV block (NaN in the
        float pool leaves or scale tiles; the guard must catch what
        follows) and arm a one-shot allocator failure (admission must
        absorb it)."""
        step = self._step_count
        if (self.scheduler.decoding
                and self.injector.fire("kv_corrupt", step)):
            reqs = [self.scheduler.decoding[s]
                    for s in sorted(self.scheduler.decoding)]
            victim = reqs[self.injector.choose("kv_corrupt", step,
                                               len(reqs))]
            alloc = self.scheduler.allocator
            bs = self.layout.block_size
            # a private block that already holds cached tokens: its NaNs
            # enter the victim's next attention read (a shared block
            # would poison innocent readers)
            priv = [b for b in victim.blocks if alloc.refcount(b) == 1]
            cached = [b for i, b in enumerate(victim.blocks)
                      if alloc.refcount(b) == 1
                      and i * bs < victim.num_cached - 1]
            target = (cached or priv)[:1]
            if target:
                paged.poison_blocks(self.caches, target)
        if self.injector.fire("alloc_fail", step):
            self.scheduler.allocator.fail_next = True

    def _nan_victim(self, n: int) -> int | None:
        """The ``logit_nan`` site: the index (among the step's ``n``
        decoding slots in slot order) whose logit row is NaN-filled this
        step, or None."""
        if self.injector is None or not self.injector.fire(
                "logit_nan", self._step_count):
            return None
        return self.injector.choose("logit_nan", self._step_count, n)

    # ------------------------------------------------------- internals ----

    @staticmethod
    def _sample_key(req: Request) -> torch.Tensor:
        """The request's private stream, keyed on (seed, emit index)
        only: independent of batch composition and admission timing.
        A host key ([2] int64 on the CPU)."""
        return prng.fold_in(prng.key(req.seed, device="cpu"),
                            len(req.output))

    def _sample_override(self, rows: torch.Tensor, toks: torch.Tensor,
                         sampled: list) -> torch.Tensor:
        """Replace the greedy choice of each sampled (row, request) pair
        by its keyed draw: one ``_sample_rows`` per distinct ``top_k``
        (usually one), on the device; only the keys and temperatures
        cross, as one upload each."""
        by_k: dict[int, list] = {}
        for idx, req in sampled:
            by_k.setdefault(req.top_k, []).append((idx, req))
        for top_k, items in by_k.items():
            # [S, 3] int64: the row index, then the row's key
            meta = torch.cat([torch.tensor([[i] for i, _ in items]),
                              torch.stack([self._sample_key(r)
                                           for _, r in items])], dim=1)
            meta = meta.to(self.device)
            temps = torch.tensor([r.temperature for _, r in items],
                                 dtype=torch.float32).to(self.device)
            toks[meta[:, 0]] = _sample_rows(rows[meta[:, 0]], temps,
                                            meta[:, 1:], top_k
                                            ).to(toks.dtype)
        return toks

    def _choose(self, rows: torch.Tensor, row_reqs: list) -> torch.Tensor:
        """The step's tokens [B] (int32, on the device): the greedy
        argmax, overridden for the sampled (row, request) pairs."""
        toks = _greedy_tokens(rows)
        sampled = [(i, r) for i, r in row_reqs if r.temperature > 0.0]
        if sampled:
            toks = self._sample_override(rows, toks, sampled)
        return toks

    def _emit_first_token(self, req: Request, logits: torch.Tensor) -> None:
        """The final prefill chunk's logits yield the first token."""
        row = logits.reshape(1, -1)
        toks = self._choose(row, [(0, req)])
        packed = _pack(toks, _logit_stats(row, toks)).cpu().numpy()
        tok = int(packed[0, 0])
        stats = {k: packed[i + 1] for i, k in enumerate(_STAT_KEYS)}
        self.scheduler.start_decoding(req)
        tripped = self._guard_tripped(stats, [(0, req)])
        if tripped:
            self._quarantine(req, tripped[0][1])
            return
        req.output.append(tok)
        req.logprobs.append(float(stats["logprob"][0]))
        self._next_tokens[req.slot, 0] = tok
        if self._finished(req, tok):
            self._retire(req)

    def _decode_step(self) -> None:
        prefilling = [r.slot for r in self.scheduler.prefilling]
        old_len = self.caches["len"].clone() if prefilling else None
        tok_in = torch.from_numpy(self._next_tokens).to(self.device)
        logits = self._decode(self.params, tok_in, self.caches)
        rows = logits.reshape(logits.shape[0], -1)
        if prefilling:
            # the batched step also advanced mid-prefill slots' lengths
            mask = torch.zeros(self.max_slots, dtype=torch.bool,
                               device=self.device)
            mask[prefilling] = True
            paged.keep_slots(self.caches, old_len, mask)
        slots_sorted = sorted(self.scheduler.decoding)
        victim = self._nan_victim(len(slots_sorted))
        if victim is not None:
            # the guard's nonfinite sentinel must quarantine this row
            rows[slots_sorted[victim]] = float("nan")
        # greedy argmax, the sampled override, then the fused logit stats
        # of the final choices: one [7, B] transfer covers the step
        toks = self._choose(rows, list(self.scheduler.decoding.items()))
        packed = _pack(toks, _logit_stats(rows, toks)).cpu().numpy()
        tokens = packed[0].astype(np.int32)
        self.last_logit_stats = {k: packed[i + 1]
                                 for i, k in enumerate(_STAT_KEYS)}
        self._account_decode()
        tripped = self._guard_tripped(
            self.last_logit_stats, list(self.scheduler.decoding.items()))
        skip = {req.rid for req, _ in tripped}
        retired = []
        for slot, req in self.scheduler.decoding.items():
            if req.rid in skip:
                continue
            tok = int(tokens[slot])
            req.output.append(tok)
            req.logprobs.append(float(self.last_logit_stats["logprob"][slot]))
            req.last_progress_step = self._step_count
            self._next_tokens[slot, 0] = tok
            if self._finished(req, tok):
                retired.append(req)
        for req, reason in tripped:
            self._quarantine(req, reason)
        for req in retired:
            self._retire(req)

    def _guard_tripped(self, stats: dict, row_reqs) -> list:
        if self.guard is None:
            return []
        reasons = self.guard.check_rows(stats)
        return [(req, reasons[idx]) for idx, req in row_reqs
                if idx in reasons]

    def _quarantine(self, req: Request, reason: str) -> None:
        """A guard tripped on this slot: scrub its private blocks, release
        everything and park the request on ``self.quarantined``."""
        self.kv_stats["guard_trips"] += 1
        req.error = reason
        self._on_drop(req)
        alloc = self.scheduler.allocator
        scrub = [b for b in req.blocks if alloc.refcount(b) == 1]
        if scrub:
            paged.zero_blocks(self.caches, scrub)
        slot = req.slot
        self.scheduler.drop(req, "quarantined")
        paged.reset_slot(self.caches, slot, self._null_row)
        req.slot = None
        self.quarantined.append(req)

    def _finished(self, req: Request, tok: int) -> bool:
        return (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id))

    def _retire(self, req: Request) -> None:
        slot = req.slot
        self._on_retire(req)
        self.scheduler.retire(req)
        # point the slot back at the null block so later batched steps'
        # stray writes cannot touch re-allocated blocks
        paged.reset_slot(self.caches, slot, self._null_row)

    def _account_decode(self) -> None:
        bs = self.layout.block_size
        touched = sum(paged.cdiv(r.num_cached + 1, bs) * bs
                      for r in self.scheduler.decoding.values())
        self.kv_stats["paged_bytes"] += touched * self._token_bytes
        self.kv_stats["paged_bytes_bf16"] += touched * self._token_bytes_bf16
        self.kv_stats["contiguous_bytes"] += (len(self.scheduler.decoding)
                                              * self.layout.max_context
                                              * self._token_bytes)
        self.kv_stats["decode_steps"] += 1

    def _account_prefill(self, cached: int, *, first: bool) -> None:
        bs = self.layout.block_size
        touched = paged.cdiv(cached, bs) * bs
        self.kv_stats["paged_bytes"] += touched * self._token_bytes
        self.kv_stats["paged_bytes_bf16"] += touched * self._token_bytes_bf16
        if first:
            self.kv_stats["contiguous_bytes"] += (self.layout.max_context
                                                  * self._token_bytes)
        self.kv_stats["prefill_chunks"] += 1


class SpecDecodeEngine(DecodeEngine):
    """Speculative continuous-batching engine: draft -> verify -> accept.

    Each engine step still admits and runs one prefill chunk (the
    proposer mirrors both through the hooks), but the batched decode step
    becomes a draft / verify cycle: the proposer guesses up to ``spec_k``
    tokens per decoding slot, ONE fixed-shape ``verify_fn`` pass scores
    every slot's window against the paged KV (quantized pools included),
    and the greedy accept rule emits 1 to k + 1 tokens per slot. The
    tokens emitted per KV-pool walk are the gain: the walk is the decode
    step's dominant traffic.

    For greedy slots the accept rule runs on the device too: the argmax
    of every window position, the accepted prefix and the fused logit
    statistics of the chosen tokens (the emitted ones; token 0 past them
    and on padding rows) cross to the host as ONE packed [7, S * C]
    tensor.

    Rolling back a rejected suffix is bookkeeping: the slot's ``len``
    drops to the accepted prefix (``paged.set_lens``), blocks stay
    allocated, and rows past ``len`` are masked by every reader and
    overwritten by the next append. Paged-KV attention families only.

    Sampled requests take the exact accept / residual rule
    (``repro_torch.spec.sampler.rejection_sample``), keyed on (seed,
    emit index): reproducible and batch-invariant, with the emitted
    marginal exactly the target distribution. A step with a sampled slot
    pulls those slots' [C, V] rows to the host, as the reference does.
    """

    def __init__(self, cfg: ModelConfig, params, *, proposer,
                 spec_k: int = 4, **kw):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(
                f"speculative decoding needs a rollback-able paged KV "
                f"cache; family {cfg.family!r} carries recurrent state")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        super().__init__(cfg, params, **kw)
        self.proposer = proposer
        self.spec_k = int(spec_k)
        self._verify = api.verify_fn(cfg)
        self.kv_stats.update({"spec_steps": 0, "spec_slot_steps": 0,
                              "spec_drafted": 0, "spec_accepted": 0,
                              "spec_emitted": 0, "proposer_stalls": 0})
        proposer.attach(self)

    # the proposer mirrors admission, prompt caching and retirement -------
    def _on_admit(self, req: Request) -> None:
        self.proposer.on_admit(req)

    def _on_prefill_chunk(self, req: Request, chunk: list,
                          pos0: int) -> None:
        self.proposer.on_prefill_chunk(req, chunk, pos0)

    def _on_retire(self, req: Request) -> None:
        self.proposer.on_retire(req)

    def _on_preempt(self, req: Request) -> None:
        self.proposer.on_preempt(req)

    def _on_restore(self, req: Request) -> None:
        self.proposer.on_restore(req)

    def _on_drop(self, req: Request) -> None:
        self.proposer.on_retire(req)

    # ------------------------------------------------------- spec step ----

    def _effective_k(self, req: Request) -> int:
        """Drafts worth proposing for ``req`` now: the engine's window,
        the request's ``spec_k``, the remaining token budget and the
        slot's allocated blocks all cap it. k = 0 is a plain decode step
        on the verify path."""
        k = self.spec_k if req.spec_k is None else min(req.spec_k,
                                                       self.spec_k)
        k = min(k, req.max_new_tokens - len(req.output) - 1)
        cached = req.prefill_pos + len(req.output) - 1
        capacity = len(req.blocks) * self.layout.block_size
        return max(0, min(k, capacity - cached - 1))

    def _accept_greedy(self, logits: torch.Tensor, tok: torch.Tensor,
                       ks: list[int]) -> np.ndarray:
        """The greedy accept rule and the fused logit stats on the device
        -> packed [7, S * C] on the host: row 0 the argmax of every
        position, rows 1.. the stats of the chosen tokens (the emitted
        ones; token 0 past them and on padding rows)."""
        dev = self.device
        s, c, v = logits.shape
        rows = logits.reshape(s * c, v)
        am = _greedy_tokens(rows).reshape(s, c)
        k_row = torch.zeros(s, dtype=torch.int32)
        k_row[:len(ks)] = torch.tensor(ks, dtype=torch.int32)
        k_row = k_row.to(dev)
        col = torch.arange(c, device=dev)
        match = (am[:, :-1] == tok[:, 1:]) & (col[None, :-1] < k_row[:, None])
        acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        real = torch.arange(s, device=dev) < len(ks)
        chosen = torch.where((col[None, :] <= acc[:, None]) & real[:, None],
                             am, torch.zeros_like(am))
        stats = _logit_stats(rows, chosen.reshape(-1))
        return _pack(am.reshape(-1), stats).cpu().numpy()

    def _accept_sampled(self, logits: torch.Tensor, tokens: np.ndarray,
                        decoding: list, ks: list[int], drafts: list,
                        qdists: list) -> tuple[list, list, dict]:
        """A step with sampled slots: the argmax of every position and the
        sampled slots' [C, V] rows cross to the host, greedy slots take
        the argmax-prefix rule and sampled slots ``rejection_sample``;
        then ONE ``_logit_stats`` prices every emitted token. Returns
        (accepted counts, emitted tokens, host stats [S, C] each)."""
        from repro_torch.spec import sampler

        s, c, v = logits.shape
        rows = logits.reshape(s * c, v)
        argmax = _greedy_tokens(rows).reshape(s, c).cpu().numpy()
        drawn = [i for i, r in enumerate(decoding) if r.temperature > 0.0]
        host = logits[torch.tensor(drawn, device=self.device)] \
            .to(torch.float32).cpu().numpy()
        accepted, emitted_all = [], []
        for i, req in enumerate(decoding):
            if req.temperature <= 0.0:
                acc, emitted = sampler.greedy_verify(argmax[i],
                                                     drafts[i][:ks[i]])
            else:
                acc, emitted = sampler.rejection_sample(
                    host[drawn.index(i)], drafts[i][:ks[i]], qdists[i],
                    req.temperature, req.top_k, req.seed, len(req.output))
            accepted.append(acc)
            emitted_all.append(emitted)
        chosen = np.zeros(tokens.shape, np.int32)
        for i, emitted in enumerate(emitted_all):
            chosen[i, :len(emitted)] = emitted
        stats = _logit_stats(rows, torch.from_numpy(chosen.reshape(-1))
                             .to(self.device))
        packed = torch.stack([stats[k] for k in _STAT_KEYS]).cpu().numpy()
        return accepted, emitted_all, {
            k: packed[i].reshape(tokens.shape)
            for i, k in enumerate(_STAT_KEYS)}

    def _decode_step(self) -> None:
        from repro_torch.spec.sampler import greedy_verify
        from repro_torch.spec.verify import pack_windows

        decoding = [self.scheduler.decoding[s]
                    for s in sorted(self.scheduler.decoding)]
        ks = [self._effective_k(r) for r in decoding]
        stalled = (self.injector is not None
                   and self.injector.fire("proposer_stall",
                                          self._step_count))
        if not stalled:
            try:
                drafts, qdists = self.proposer.propose(decoding, ks)
            except ProposerStallError:
                stalled = True
        if stalled:
            # degrade, don't crash: no drafts make this step the plain
            # verify-path decode, one exact token per slot
            drafts = [[] for _ in decoding]
            qdists = [None] * len(decoding)
            ks = [0] * len(decoding)
            self.kv_stats["proposer_stalls"] += 1
        window = self.spec_k + 1
        tokens, slots, pos0s = pack_windows(decoding, ks, drafts,
                                            self.max_slots, window)
        dev = self.device
        tok = torch.from_numpy(tokens).to(dev)
        logits = self._verify(self.params, tok, self.caches,
                              torch.from_numpy(slots).to(dev),
                              torch.from_numpy(pos0s).to(dev))
        victim = self._nan_victim(len(decoding))
        if victim is not None:
            logits[victim] = float("nan")
        if any(r.temperature > 0.0 for r in decoding):
            accepted, emitted_all, self.last_logit_stats = \
                self._accept_sampled(logits, tokens, decoding, ks, drafts,
                                     qdists)
        else:
            # greedy slots only: the accept rule runs on the device and
            # ONE packed transfer covers the step
            packed = self._accept_greedy(logits, tok, ks)
            argmax = packed[0].astype(np.int32).reshape(tokens.shape)
            self.last_logit_stats = {k: packed[i + 1].reshape(tokens.shape)
                                     for i, k in enumerate(_STAT_KEYS)}
            accepted, emitted_all = [], []
            for i in range(len(decoding)):
                acc, emitted = greedy_verify(argmax[i], drafts[i][:ks[i]])
                accepted.append(acc)
                emitted_all.append(emitted)
        logprobs = self.last_logit_stats["logprob"]
        new_lens = [int(pos0s[i]) + 1 + acc for i, acc in enumerate(accepted)]

        # rollback: rejected suffixes disappear by length bookkeeping
        lens_pad = np.full((self.max_slots,), new_lens[0], np.int32)
        lens_pad[:len(decoding)] = new_lens
        paged.set_lens(self.caches, torch.from_numpy(slots).to(dev),
                       torch.from_numpy(lens_pad).to(dev))
        self._account_spec(pos0s[:len(decoding)], ks, emitted_all, accepted)

        tripped = self._guard_tripped(self.last_logit_stats,
                                      list(enumerate(decoding)))
        skip = {req.rid for req, _ in tripped}
        retired, alive, alive_lens = [], [], []
        for i, req in enumerate(decoding):
            if req.rid in skip:
                continue
            done = False
            for j, tok_j in enumerate(emitted_all[i]):
                req.output.append(int(tok_j))
                req.logprobs.append(float(logprobs[i, j]))
                if self._finished(req, int(tok_j)):
                    done = True
                    break
            req.last_progress_step = self._step_count
            self._next_tokens[req.slot, 0] = req.output[-1]
            if done:
                retired.append(req)
            else:
                alive.append(req)
                alive_lens.append(new_lens[i])
        self.proposer.sync(alive, alive_lens)
        for req, reason in tripped:
            self._quarantine(req, reason)
        for req in retired:
            self._retire(req)

    def _account_spec(self, pos0s, ks, emitted_all, accepted) -> None:
        bs = self.layout.block_size
        window = self.spec_k + 1
        # one KV-pool walk per slot covers the whole window; the
        # contiguous baseline still pays a max_context row per token
        touched = sum(paged.cdiv(int(p) + window, bs) * bs for p in pos0s)
        n_emitted = sum(len(e) for e in emitted_all)
        self.kv_stats["paged_bytes"] += touched * self._token_bytes
        self.kv_stats["paged_bytes_bf16"] += touched * self._token_bytes_bf16
        self.kv_stats["contiguous_bytes"] += (n_emitted
                                              * self.layout.max_context
                                              * self._token_bytes)
        self.kv_stats["decode_steps"] += 1
        self.kv_stats["spec_steps"] += 1
        self.kv_stats["spec_slot_steps"] += len(pos0s)
        self.kv_stats["spec_drafted"] += sum(ks)
        self.kv_stats["spec_accepted"] += sum(accepted)
        self.kv_stats["spec_emitted"] += n_emitted

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the target accepted so far."""
        drafted = self.kv_stats["spec_drafted"]
        return self.kv_stats["spec_accepted"] / drafted if drafted else 0.0

    @property
    def mean_accepted_length(self) -> float:
        """Tokens emitted per per-slot verify walk."""
        walks = self.kv_stats["spec_slot_steps"]
        return self.kv_stats["spec_emitted"] / walks if walks else 0.0
