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

``prefix_cache=True`` adds the radix layer
(``repro_torch.serving.prefix_cache``): admission walks a block-granular
trie over the prompt, maps the hit's pool blocks into the slot's table
(copy-on-write at a mid-block divergence) and starts chunked prefill at
the first uncached token; retirement inserts the request's history for
later requests, with LRU eviction of unreferenced trie leaves (spilled
to host memory when ``spill_blocks`` arms the tier) when the free list
runs short. ``preempt`` arms preemption to host under pool pressure:
a decoding victim's blocks snapshot to host (``serving.swap.KVSwap``)
and restore bitwise on re-admission.

``telemetry`` attaches a ``repro_torch.obs.Telemetry``: lifecycle spans
and instants on the engine-step clock (``obs.trace``), the typed metrics
registry (``metrics_registry`` / ``metrics_snapshot`` /
``metrics_prometheus``) and, with ``profile=True``, the ECM attribution
profiler. The default, ``obs.NULL``, leaves every step as it is: the
same launches and the one host transfer.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import obs
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.models import api, paged
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import NULL_BLOCK, PagedLayout
from repro_torch.serving.faults import (AdmissionError, AllocatorError,
                                        NumericsGuard, ProposerStallError,
                                        StallError)
from repro_torch.serving.prefix_cache import PrefixCache, PrefixMatch
from repro_torch.serving.swap import KVSwap, PrefixSpill

DEFAULT_BLOCK_SIZE = paged.DEFAULT_BLOCK_SIZE


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
    output: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)   # per emitted token
    slot: int | None = None
    done: bool = False
    prefill_pos: int = 0                           # prompt tokens cached
    blocks: list = field(default_factory=list)     # pool blocks referenced
    # prefix caching: tokens served from the trie at admission (prefill
    # starts at the first uncached token) and, until the engine copies
    # it, the shared block awaiting its copy-on-write
    prefix_hit: int = 0
    cow_src: int | None = None
    # lifecycle: a deadline in engine steps from submission (None: none);
    # ``priority`` feeds the "priority" preemption policy (higher
    # survives). ``state`` walks queued -> prefilling -> decoding
    # (-> preempted -> decoding)* -> done | cancelled | expired |
    # quarantined | failed
    deadline_steps: int | None = None
    priority: int = 0
    state: str = "queued"
    error: str | None = None
    submit_step: int = 0
    last_progress_step: int = 0
    admit_seq: int = -1
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
        self.prefix_hit = 0
        self.cow_src = None
        self.state = "queued"
        self.admit_seq = -1
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
    """FIFO admission + slot assignment + chunked-prefill bookkeeping,
    with the prefix cache's match plans and the preempted queue."""

    def __init__(self, allocator: BlockAllocator, max_slots: int,
                 layout: PagedLayout, prefill_chunk: int,
                 prefix_cache: PrefixCache | None = None,
                 session_kv: bool = True):
        self.allocator = allocator
        self.layout = layout
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = prefix_cache
        # session KV: retirement caches prompt + emitted output (the
        # conversation's history), not the prompt alone
        self.session_kv = session_kv
        self.waiting: deque[Request] = deque()
        self.prefilling: deque[Request] = deque()
        self.decoding: dict[int, Request] = {}
        self.preempted: deque[Request] = deque()
        self._free_slots = list(range(max_slots))
        self._admit_seq = 0

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

    def _match_candidates(self, req: Request) -> list[PrefixMatch]:
        """Admission plans for ``req``, best hit first. A copy-on-write
        hit pins one block beyond the request's own budget (the shared
        source), so a request sized at the pool's capacity may be
        admittable only under a lesser plan: each fallback pins strictly
        less (drop the copy, keeping the block-aligned hit; then cold,
        where every trie block is evictable). The cold plan needs
        ``blocks_needed`` <= the usable pool, which ``submit`` checked, so
        admission cannot livelock."""
        if self.prefix_cache is None:
            return [PrefixMatch()]
        pc = self.prefix_cache
        m = pc.match(req.prompt)
        # the spill tier: page the longest host-resident continuation
        # back (gated inside promote), then match again so the plans see
        # the promoted nodes as resident
        if pc.spill is not None and pc.promote(req.prompt, rid=req.rid):
            m = pc.match(req.prompt)
        cands = [m]
        if m.cow_src is not None:
            cands.append(PrefixMatch(m.blocks,
                                     len(m.blocks) * self.layout.block_size,
                                     None))
        if m.blocks:
            cands.append(PrefixMatch())
        return cands

    def _try_admit(self, req: Request, match: PrefixMatch) -> bool:
        """One admission attempt under one plan: retain the shared blocks
        first (so no eviction, from this attempt or a later one in the
        same sweep, can take them), evict unreferenced trie leaves if the
        rest does not fit, then allocate or roll the retains back."""
        pc = self.prefix_cache
        if pc is not None:
            self.allocator.retain(match.blocks)
            if match.cow_src is not None:
                self.allocator.retain([match.cow_src])
        need = self.blocks_needed(req) - len(match.blocks)
        if need > self.allocator.num_free and pc is not None:
            pc.evict(need - self.allocator.num_free)
        fresh = None
        if need <= self.allocator.num_free:
            try:
                fresh = self.allocator.alloc(need)
            except AllocatorError:
                pass           # a transient failure: the head waits
        if fresh is None:
            if pc is not None:
                self.allocator.release(match.blocks)
                if match.cow_src is not None:
                    self.allocator.release([match.cow_src])
            return False
        req.blocks = match.blocks + fresh
        req.prefix_hit = match.hit
        req.cow_src = match.cow_src       # the engine copies, then releases
        req.prefill_pos = match.hit       # the first uncached token
        if pc is not None:
            pc.note_admitted(match.hit, len(req.prompt),
                             match.cow_src is not None, rid=req.rid)
        return True

    def admit(self) -> list[Request]:
        """Move waiting requests into slots while capacity lasts. Strict
        FIFO: the queue head blocks (no skip-ahead).

        With a prefix cache, the head's plans are tried best first
        (``_match_candidates``); if even the cold plan does not fit after
        evicting unreferenced trie leaves, the head waits, and the
        retirement of live requests eventually unblocks it. Preempted
        requests re-admit only once the waiting queue has drained (a
        restore that displaced the request whose admission forced the
        preemption would thrash); they need no match, their content
        comes back from the host snapshot."""
        admitted = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            if not any(self._try_admit(req, m)
                       for m in self._match_candidates(req)):
                break
            self.waiting.popleft()
            req.slot = self._free_slots.pop()
            req.state = "prefilling"
            self._stamp(req)
            self.prefilling.append(req)
            admitted.append(req)
        while not self.waiting and self.preempted and self._free_slots:
            req = self.preempted[0]
            need = self.blocks_needed(req)
            if need > self.allocator.num_free and self.prefix_cache:
                self.prefix_cache.evict(need - self.allocator.num_free)
            if need > self.allocator.num_free:
                break
            try:
                req.blocks = self.allocator.alloc(need)
            except AllocatorError:
                break
            self.preempted.popleft()
            req.slot = self._free_slots.pop()
            self._stamp(req)
            admitted.append(req)   # the engine restores, then decodes
        return admitted

    def _stamp(self, req: Request) -> None:
        req.admit_seq = self._admit_seq
        self._admit_seq += 1

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

    def preempt(self, req: Request) -> None:
        """The bookkeeping half of preemption to host (the engine has
        snapshotted the blocks): leave the decode batch, release the
        blocks (trie-shared ones survive through their refcounts), free
        the slot and queue for re-admission."""
        if self.decoding.get(req.slot) is not req:
            raise AssertionError("only decoding requests preempt")
        self.decoding.pop(req.slot)
        self._release(req)
        req.slot = None
        req.state = "preempted"
        self.preempted.append(req)

    def drop(self, req: Request, state: str) -> bool:
        """Remove ``req`` from whichever queue holds it (cancellation,
        expiry, quarantine), releasing its slot and blocks. False if the
        request is not in flight. The engine resets the slot's table and
        drops a preempted request's host snapshot. A partial prompt is
        not inserted into the trie."""
        if req in self.waiting:
            self.waiting.remove(req)
        elif req in self.preempted:
            self.preempted.remove(req)
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
        if self.prefix_cache is not None:
            # cache the request's tokens before releasing: new nodes
            # retain their blocks. Session KV caches the whole history;
            # only len(output) - 1 output tokens are resident (the last
            # waits in the next-token buffer)
            seq = req.prompt
            if self.session_kv and req.output:
                n_valid = len(req.prompt) + len(req.output) - 1
                seq = (list(req.prompt) + list(req.output))[:n_valid]
            self.prefix_cache.insert(seq, req.blocks)
        self._release(req)

    @property
    def num_unfinished(self) -> int:
        return (len(self.waiting) + len(self.prefilling)
                + len(self.decoding) + len(self.preempted))


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

    ``preempt`` arms preemption to host under pool pressure: when the
    FIFO head cannot be admitted, a decoding victim's blocks snapshot to
    host memory (``KVSwap``) and it re-admits bitwise later. ``"lru"``
    picks the most recently admitted victim (least work to redo),
    ``"priority"`` the lowest ``Request.priority`` strictly below the
    head's.

    ``prefix_cache`` shares the blocks of cached prefixes between
    requests. Session KV (``session_kv``, default on) caches a retired
    request's whole history, prompt and output, so a conversation's next
    turn hits on everything already computed. ``spill_blocks`` arms the
    host spill tier: evicted trie blocks snapshot to host memory
    (``PrefixSpill``, capacity in blocks; 0 drops them) and promote back
    into free pool blocks when the restore-vs-reprefill forecast favours
    the host link. ``promote`` picks that gate: ``"auto"`` evaluates
    ``repro_torch.ecm.hopper.predicted_restore_vs_reprefill`` on this
    engine's KV geometry and parameter count with the H100's figures,
    ``"always"`` / ``"never"`` force it.

    ``telemetry`` attaches a ``repro_torch.obs.Telemetry``, shared with
    the prefix cache, the spill and swap tiers and the fault injector.
    """

    PREEMPT_POLICIES = ("off", "lru", "priority")
    PROMOTE_MODES = ("auto", "always", "never")

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_context: int = 256,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 num_blocks: int | None = None, prefill_chunk: int = 32,
                 prefix_cache: bool = False, session_kv: bool = True,
                 spill_blocks: int = 0, promote: str = "auto",
                 preempt: str = "off",
                 guard: NumericsGuard | None = NumericsGuard(),
                 fault_injector=None,
                 telemetry: obs.Telemetry | None = None, device=None):
        if prefix_cache and cfg.family == "ssm":
            raise ValueError(
                "prefix caching shares paged KV blocks; the 'ssm' family "
                "carries constant-size recurrent state with no per-token "
                "KV to share")
        if preempt not in self.PREEMPT_POLICIES:
            raise ValueError(f"preempt must be one of "
                             f"{self.PREEMPT_POLICIES}, got {preempt!r}")
        if promote not in self.PROMOTE_MODES:
            raise ValueError(f"promote must be one of "
                             f"{self.PROMOTE_MODES}, got {promote!r}")
        if spill_blocks and not prefix_cache:
            raise ValueError(
                "spill_blocks arms the prefix-cache host spill tier and "
                "needs prefix_cache=True")
        if preempt != "off" and cfg.family == "ssm":
            raise ValueError(
                "preemption snapshots paged KV blocks; the 'ssm' family "
                "carries recurrent state that cannot be swapped out "
                "block-wise")
        self.device = _device.resolve(device)
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
        allocator = BlockAllocator(self.kv.num_blocks)
        self.prefix_cache = (PrefixCache(allocator, self.layout.block_size)
                             if prefix_cache else None)
        self.scheduler = Scheduler(allocator, max_slots, self.layout,
                                   prefill_chunk,
                                   prefix_cache=self.prefix_cache,
                                   session_kv=session_kv)
        self.preempt_policy = preempt
        self.guard = guard
        self.injector = fault_injector
        self.swap = KVSwap()
        self.quarantined: list[Request] = []
        self._step_count = 0
        # telemetry: every hook guards on ``self.obs.enabled``, so the
        # default NULL recorder runs the step as it is; the components
        # share the engine's handle (one step clock, one event stream)
        self.obs = telemetry if telemetry is not None else obs.NULL
        self.swap.obs = self.obs
        if self.prefix_cache is not None:
            self.prefix_cache.obs = self.obs
        if fault_injector is not None:
            fault_injector.obs = self.obs
        if self.obs.enabled:
            m = self.obs.metrics
            self._h_ttft = m.histogram(
                "ttft_steps", unit="steps",
                help="engine steps from submit to first emitted token")
            self._h_queue_wait = m.histogram(
                "queue_wait_steps", unit="steps",
                help="engine steps from submit to slot admission")
            self._h_intertoken = m.histogram(
                "intertoken_seconds", unit="s",
                help="wall-clock decode/verify step latency "
                     "(~ inter-token latency per resident request)",
                buckets=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
                         0.1, 0.3, 1.0, 3.0))
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
        self._costs = None
        if self.obs.profile is not None:
            from repro_torch.obs.profile import CostModel
            self._costs = CostModel(cfg, self.params, self._token_bytes)
        # prefix counters stay zero with the cache off:
        # ``prefix_saved_bytes`` prices the hit tokens at the per-token
        # pool bytes (the KV the hits never re-stored), and
        # prefix_hit_tokens / prefix_prompt_tokens is the hit rate
        self.kv_stats = {"paged_bytes": 0, "paged_bytes_bf16": 0,
                         "contiguous_bytes": 0, "decode_steps": 0,
                         "prefill_chunks": 0, "prefill_tokens": 0,
                         "prefix_hit_tokens": 0, "prefix_prompt_tokens": 0,
                         "prefix_saved_bytes": 0, "prefix_cow_blocks": 0,
                         "prefix_evicted_blocks": 0,
                         "prefix_spilled_blocks": 0,
                         "prefix_spilled_bytes": 0,
                         "prefix_promoted_blocks": 0,
                         "prefix_promoted_tokens": 0,
                         "preempted": 0, "preempted_blocks": 0,
                         "restored_blocks": 0,
                         "guard_trips": 0, "cancelled": 0, "expired": 0,
                         "alloc_faults": 0, "stalled_requests": 0}
        self.last_logit_stats: dict | None = None
        # the spill tier, armed last: its snapshot closure reads the live
        # cache tree, and the auto gate prices this engine's geometry
        if self.prefix_cache is not None and spill_blocks:
            self.prefix_cache.spill = PrefixSpill(
                spill_blocks,
                lambda blocks: paged.extract_blocks(self.caches, blocks))
            self.prefix_cache.spill.obs = self.obs
            self.prefix_cache.promote_fn = self._promote_restore
            self.prefix_cache.promote_ratio = self._promote_gate(promote)

    # ------------------------------------------------------------ API -----

    def submit(self, req: Request) -> None:
        """Enqueue a request; raises ``AdmissionError`` for requests that
        could never run (context or pool overflow, bad deadline)."""
        req.submit_step = self._step_count
        req.last_progress_step = self._step_count
        self.scheduler.submit(req)
        if self.obs.enabled:
            self.obs.trace.begin("queued", rid=req.rid,
                                 prompt_tokens=len(req.prompt),
                                 max_new=req.max_new_tokens)

    def step(self) -> None:
        """One engine step: expire deadlines, inject the step's faults,
        admit (preempting a victim to host under pool pressure if armed),
        run at most one prefill chunk, then one batched decode step for
        every decoding slot."""
        self._step_count += 1
        if self.obs.enabled:
            self.obs.set_step(self._step_count)
        self._expire_deadlines()
        if self.injector is not None:
            self._inject_step_faults()
        admitted = self.scheduler.admit()
        if self.preempt_policy != "off":
            # the FIFO head could not be admitted: swap a decoding victim
            # to host and try again (each spin shrinks the batch by one)
            spins = 0
            while (self.scheduler.waiting and self.scheduler.decoding
                   and spins < self.max_slots and self._preempt_for_head()):
                spins += 1
                admitted += self.scheduler.admit()
        for req in admitted:
            if req.state == "preempted":
                self._restore(req)
            else:
                self._admit_slot(req)
        nxt = self.scheduler.next_chunk()
        if nxt is not None:
            req, chunk, pos0 = nxt
            tok = torch.tensor([chunk], dtype=torch.int32, device=self.device)
            n = len(chunk)
            logits = self._run_phase(
                "prefill_chunk",
                lambda: self._prefill_chunk(self.params, tok, self.caches,
                                            req.slot, pos0),
                lambda: ((n, pos0),
                         lambda: self._costs.prefill_chunk(n, pos0),
                         tok.numel() * tok.element_size()))
            self._on_prefill_chunk(req, chunk, pos0)
            if self.obs.enabled:
                self.obs.trace.instant("prefill_chunk", rid=req.rid,
                                       pos0=pos0, tokens=len(chunk))
            req.last_progress_step = self._step_count
            self.kv_stats["prefill_tokens"] += len(chunk)
            self._account_prefill(pos0 + len(chunk),
                                  first=pos0 == req.prefix_hit)
            if self.scheduler.prefill_advance(req, len(chunk)):
                self._emit_first_token(req, logits)
        if self.scheduler.decoding:
            if self.obs.enabled:
                self._observed_decode_step()
            else:
                self._decode_step()
        self.kv_stats["alloc_faults"] = self.scheduler.allocator.faults

    # ------------------------------------------------------- telemetry ----

    def _run_phase(self, name: str, fn, counters, launch_key=()):
        """``fn()`` as one call of the profiler's phase ``name``, or just
        ``fn()`` without a profiler. ``counters()``, evaluated after ``fn``
        ran, gives (shape signature, a thunk of the phase's ``CostModel``
        cost, host-link bytes)."""
        prof = self.obs.profile
        if prof is None:
            return fn()
        with prof.phase(name, self.device, launch_key) as ph:
            out = fn()
            sig, cost, ph.host_bytes = counters()
            ph.cost = prof.cost(name, sig, cost)
        return out

    def _copy_counters(self, nbytes: int):
        return (nbytes,), lambda: self._costs.copy(nbytes), nbytes

    _STEP_PHASE = "decode_step"

    def _step_counters(self):
        """The decode step's (signature, cost thunk, host bytes): every
        slot's row runs; the live slots read their touched blocks."""
        bs = self.layout.block_size
        rows = self.max_slots
        ctx = sum(paged.cdiv(r.num_cached + 1, bs) * bs
                  for r in self.scheduler.decoding.values())
        # tokens up, the packed [7, B] f32 stats down
        return ((rows, ctx), lambda: self._costs.decode_step(rows, ctx),
                rows * 4 + 7 * rows * 4)

    def _observed_decode_step(self) -> None:
        """The decode (or verify) step with telemetry attached: its wall
        time into the inter-token histogram (``wall_clock``), and one call
        of the profiler's step phase, keyed for launch counting by whether
        slots were mid-prefill and the sampled slots' top_k groups."""
        t0 = time.perf_counter() if self.obs.wall_clock else 0.0
        counters, key = None, ()
        if self.obs.profile is not None:
            counters = self._step_counters()    # shapes before the step
            key = (bool(self.scheduler.prefilling),
                   tuple(sorted({r.top_k for r in
                                 self.scheduler.decoding.values()
                                 if r.temperature > 0.0})))
        self._run_phase(self._STEP_PHASE, self._decode_step,
                        lambda: counters, key)
        if self.obs.wall_clock:
            self._h_intertoken.observe(time.perf_counter() - t0)

    # Units of the kv_stats counters in the typed registry and the
    # Prometheus exposition.
    _METRIC_UNITS = {
        "paged_bytes": "bytes", "paged_bytes_bf16": "bytes",
        "contiguous_bytes": "bytes", "decode_steps": "steps",
        "prefill_chunks": "chunks", "prefill_tokens": "tokens",
        "prefix_hit_tokens": "tokens", "prefix_prompt_tokens": "tokens",
        "prefix_saved_bytes": "bytes", "prefix_cow_blocks": "blocks",
        "prefix_evicted_blocks": "blocks",
        "prefix_spilled_blocks": "blocks", "prefix_spilled_bytes": "bytes",
        "prefix_promoted_blocks": "blocks",
        "prefix_promoted_tokens": "tokens", "preempted": "requests",
        "preempted_blocks": "blocks", "restored_blocks": "blocks",
        "guard_trips": "trips", "cancelled": "requests",
        "expired": "requests", "alloc_faults": "faults",
        "stalled_requests": "requests", "spec_steps": "steps",
        "spec_slot_steps": "walks", "spec_drafted": "tokens",
        "spec_accepted": "tokens", "spec_emitted": "tokens",
        "proposer_stalls": "stalls",
    }

    def metrics_registry(self) -> obs.MetricsRegistry:
        """The engine's typed registry, assembled now: every ``kv_stats``
        counter mirrored verbatim (the engine's own accounting stays the
        one source), the swap tier's counters, derived-rate gauges and,
        with telemetry attached, the live TTFT / queue-wait / inter-token
        histograms."""
        reg = obs.MetricsRegistry()
        for key, val in self.kv_stats.items():
            c = reg.counter(key, unit=self._METRIC_UNITS.get(key, ""),
                            help=f"engine kv_stats[{key!r}]")
            c.value = val
        for key in ("swapped_out_blocks", "restored_blocks",
                    "dropped_blocks", "host_bytes_total",
                    "restored_bytes_total"):
            c = reg.counter(
                f"swap_{key}",
                unit="bytes" if "bytes" in key else "blocks",
                help=f"KVSwap stats[{key!r}]")
            c.value = self.swap.stats[key]
        reg.gauge("swap_host_bytes", unit="bytes",
                  help="host bytes currently holding swapped snapshots"
                  ).set(self.swap.stats["host_bytes"])
        reg.gauge("prefix_hit_rate",
                  help="fraction of admitted prompt tokens served from "
                       "the prefix cache").set(self.prefix_hit_rate)
        sp = (self.prefix_cache.spill
              if self.prefix_cache is not None else None)
        if sp is not None:
            reg.gauge("prefix_host_blocks", unit="blocks",
                      help="evicted prefix blocks currently resident in "
                           "the host spill tier").set(len(sp))
            reg.gauge("prefix_host_bytes", unit="bytes",
                      help="host bytes currently holding spilled prefix "
                           "blocks").set(sp.stats["host_bytes"])
        if self.last_logit_stats is not None:
            reg.gauge("round_off_deviation",
                      help="max round_off logit deviation over the last "
                           "decode step (paper's Kahan-vs-naive metric)"
                      ).set(float(np.max(self.last_logit_stats["round_off"])))
        if self.obs.enabled:
            reg.merge(self.obs.metrics)
        return reg

    def metrics_snapshot(self) -> dict:
        """Plain dict of every metric: every ``kv_stats`` key with the
        same value, the derived gauges and (with telemetry) histogram
        summaries."""
        return self.metrics_registry().snapshot()

    def metrics_prometheus(self) -> str:
        """Prometheus text exposition of the same registry."""
        return self.metrics_registry().to_prometheus()

    def _table_row(self, blocks: list[int]) -> torch.Tensor:
        row = torch.full((self.layout.max_blocks,), NULL_BLOCK,
                         dtype=torch.int32)
        row[:len(blocks)] = torch.as_tensor(blocks, dtype=torch.int32)
        return row.to(self.device)

    def _admit_slot(self, req: Request) -> None:
        """The device half of a fresh admission: point the slot's table
        at the request's blocks, run the copy-on-write, pre-set the
        slot's length to the hit, mirror the prefix stats."""
        paged.reset_slot(self.caches, req.slot, self._table_row(req.blocks))
        if req.cow_src is not None:
            # the table already points at the copy's target: fill it from
            # the shared block, then drop the admission's protective
            # reference on the source
            dst = req.blocks[req.prefix_hit // self.layout.block_size]
            paged.copy_block(self.caches, req.cow_src, dst)
            self.scheduler.allocator.release([req.cow_src])
            req.cow_src = None
        if req.prefix_hit:
            # readers mask from the first chunk on, and the batched
            # decode's stray write for this mid-prefill slot lands at its
            # own first writable position, never in a shared block
            self.caches["len"][:, req.slot] = req.prefix_hit
        if self.prefix_cache is not None:
            # PrefixCache.stats is the one source; the engine mirrors it
            cs = self.prefix_cache.stats
            self.kv_stats.update(
                prefix_hit_tokens=cs["hit_tokens"],
                prefix_prompt_tokens=cs["prompt_tokens"],
                prefix_cow_blocks=cs["cow_blocks"],
                prefix_evicted_blocks=cs["evicted_blocks"],
                prefix_promoted_blocks=cs["promoted_blocks"],
                prefix_promoted_tokens=cs["promoted_tokens"],
                prefix_saved_bytes=cs["hit_tokens"] * self._token_bytes)
            sp = self.prefix_cache.spill
            if sp is not None:
                self.kv_stats.update(
                    prefix_spilled_blocks=sp.stats["spilled_blocks"],
                    prefix_spilled_bytes=sp.stats["spilled_bytes_total"])
        if self.obs.enabled:
            tr = self.obs.trace
            tr.end("queued", rid=req.rid)
            tr.begin("prefill", rid=req.rid, slot=req.slot,
                     blocks=len(req.blocks), prefix_hit=req.prefix_hit)
            self._h_queue_wait.observe(self._step_count - req.submit_step)
        self._on_admit(req)

    # Subclass hooks (the speculative engine mirrors them into its
    # proposer).
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
            if self.obs.enabled:
                for d in diags:
                    self.obs.trace.instant("stall", rid=d["rid"], **{
                        k: v for k, v in d.items() if k != "rid"})
            raise StallError(f"{len(diags)} requests unfinished after "
                             f"{max_steps} steps", diags)

    def request_diagnostics(self) -> list[dict]:
        sched = self.scheduler
        out = []
        for state, reqs in (("waiting", sched.waiting),
                            ("prefilling", sched.prefilling),
                            ("decoding", sched.decoding.values()),
                            ("preempted", sched.preempted)):
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

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the prefix
        cache (0.0 with the cache off)."""
        tot = self.kv_stats["prefix_prompt_tokens"]
        return self.kv_stats["prefix_hit_tokens"] / tot if tot else 0.0

    # ----------------------------------------------- lifecycle control ----

    def _in_flight(self) -> list[Request]:
        sched = self.scheduler
        return (list(sched.waiting) + list(sched.prefilling)
                + list(sched.decoding.values()) + list(sched.preempted))

    def cancel(self, rid: int) -> bool:
        """Cancel an in-flight request wherever it is (waiting,
        prefilling, decoding, preempted), releasing its slot, blocks
        (trie-shared blocks survive through their other references), host
        snapshot and proposer mirror state. False if no such request is
        in flight."""
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

    # The lifecycle span open on a request's track, by queue state:
    # terminal paths close it before their terminal instant.
    _STATE_SPANS = {"queued": "queued", "prefilling": "prefill",
                    "decoding": "decode", "preempted": "preempted"}

    def _close_span(self, req: Request) -> None:
        span = self._STATE_SPANS.get(req.state)
        if span is not None:
            self.obs.trace.end(span, rid=req.rid)

    def _terminate(self, req: Request, state: str) -> bool:
        sched = self.scheduler
        slot = req.slot
        preempted = req in sched.preempted
        active = slot is not None and (req in sched.prefilling
                                       or sched.decoding.get(slot) is req)
        if active:
            self._on_drop(req)         # the mirror needs the slot still
        if self.obs.enabled and (active or preempted
                                 or req in sched.waiting):
            self._close_span(req)
            self.obs.trace.instant(state, rid=req.rid,
                                   emitted=len(req.output))
        if not sched.drop(req, state):
            return False
        if preempted:
            self.swap.drop(req.rid)
        if active:
            paged.reset_slot(self.caches, slot, self._null_row)
            req.slot = None
        self.kv_stats[state] += 1
        return True

    # ------------------------------------------------ preemption to host --

    def preempt(self, rid: int) -> None:
        """Preempt a decoding request: snapshot its blocks (every pool
        leaf, scale tiles included) to host memory, release them and free
        the slot. It re-admits, bitwise, once the waiting queue has
        drained (``Scheduler.admit``)."""
        req = next((r for r in self.scheduler.decoding.values()
                    if r.rid == rid), None)
        if req is None:
            raise KeyError(
                f"request {rid} is not decoding; only decoding requests "
                f"hold restorable KV state")
        slot = req.slot
        before = self.swap.stats["host_bytes_total"]
        self._run_phase(
            "swap_out",
            lambda: self.swap.swap_out(rid, self.caches, req.blocks),
            lambda: self._copy_counters(
                self.swap.stats["host_bytes_total"] - before))
        self.kv_stats["preempted"] += 1
        self.kv_stats["preempted_blocks"] += len(req.blocks)
        if self.obs.enabled:
            self.obs.trace.end("decode", rid=req.rid)
            self.obs.trace.begin("preempted", rid=req.rid,
                                 blocks=len(req.blocks))
        self._on_preempt(req)
        self.scheduler.preempt(req)
        paged.reset_slot(self.caches, slot, self._null_row)

    def _preempt_for_head(self) -> bool:
        """Pick and preempt one victim to make room for the FIFO head;
        False when the policy yields no eligible victim."""
        head = self.scheduler.waiting[0]
        cands = list(self.scheduler.decoding.values())
        if self.preempt_policy == "priority":
            victim = min(cands, key=lambda r: (r.priority, -r.admit_seq))
            if victim.priority >= head.priority:
                return False
        else:   # "lru": the most recently admitted, least work to redo
            victim = max(cands, key=lambda r: r.admit_seq)
        self.preempt(victim.rid)
        return True

    def _restore(self, req: Request) -> None:
        """The device half of re-admission after preemption: the fresh
        blocks are allocated (their ids need not match the originals),
        the host snapshot scatters back, and the slot's length returns to
        prompt + emitted - 1 (the last emitted token waits in
        ``_next_tokens``, the decode step's invariant)."""
        paged.reset_slot(self.caches, req.slot, self._table_row(req.blocks))
        before = self.swap.stats["restored_bytes_total"]
        self._run_phase(
            "swap_in",
            lambda: self.swap.swap_in(req.rid, self.caches, req.blocks),
            lambda: self._copy_counters(
                self.swap.stats["restored_bytes_total"] - before))
        self.caches["len"][:, req.slot] = (req.prefill_pos
                                           + len(req.output) - 1)
        self._next_tokens[req.slot, 0] = int(req.output[-1])
        self.kv_stats["restored_blocks"] += len(req.blocks)
        if self.obs.enabled:
            self.obs.trace.end("preempted", rid=req.rid)
            self.obs.trace.begin("decode", rid=req.rid,
                                 restored_blocks=len(req.blocks))
        req.last_progress_step = self._step_count
        self.scheduler.start_decoding(req)
        self._on_restore(req)

    # ------------------------------------------------ session spill tier --

    def _promote_gate(self, mode: str) -> float:
        """The restore-vs-reprefill ratio ``PrefixCache.promote`` gates on
        (> 1 promotes). ``"auto"`` prices one block of this engine's KV
        against re-prefilling its tokens on the H100's figures; the ratio
        does not depend on the token count."""
        if mode == "always":
            return float("inf")
        if mode == "never":
            return 0.0
        from repro_torch.ecm.hopper import predicted_restore_vs_reprefill
        return predicted_restore_vs_reprefill(
            self.layout.block_size, self._token_bytes,
            2 * api.num_params(self.params))

    def _promote_restore(self, blocks: list[int], snaps: list[dict]) -> None:
        """The device half of a spill-tier promote: one batched scatter of
        the chain's host snapshots into the fresh blocks. It runs at match
        time, so promoted blocks are valid cache content whatever the
        admission that asked for them does next."""
        snap = paged.concat_block_snapshots(snaps)
        self._run_phase(
            "prefix_promote",
            lambda: paged.restore_blocks(self.caches, blocks, snap),
            lambda: self._copy_counters(paged.snapshot_bytes(snap)))

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
        # the one stats pass the decode step does not fold in
        packed = self._run_phase(
            "ops.logit_stats",
            lambda: _pack(toks, _logit_stats(row, toks)).cpu().numpy(),
            lambda: ((row.shape[1],), lambda: self._costs.logit_stats(1),
                     7 * 4))
        tok = int(packed[0, 0])
        stats = {k: packed[i + 1] for i, k in enumerate(_STAT_KEYS)}
        self.scheduler.start_decoding(req)
        tripped = self._guard_tripped(stats, [(0, req)])
        if self.obs.enabled:
            # the decode span opens either way; a quarantine closes it
            # again (_close_span), keeping begin / end balanced
            self.obs.trace.end("prefill", rid=req.rid)
            self.obs.trace.begin("decode", rid=req.rid)
        if tripped:
            self._quarantine(req, tripped[0][1])
            return
        if self.obs.enabled:
            self._h_ttft.observe(self._step_count - req.submit_step)
        req.output.append(tok)
        req.logprobs.append(float(stats["logprob"][0]))
        self._next_tokens[req.slot, 0] = tok
        if self._finished(req, tok):
            self._retire(req)

    def _decode_step(self) -> None:
        if self.obs.enabled:
            self.obs.trace.instant("decode_step",
                                   batch=len(self.scheduler.decoding))
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
        if self.obs.enabled:
            self.obs.trace.instant("guard_trip", rid=req.rid, reason=reason)
            self._close_span(req)
            self.obs.trace.instant("quarantined", rid=req.rid,
                                   emitted=len(req.output))
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
        if self.obs.enabled:
            self.obs.trace.end("decode", rid=req.rid)
            self.obs.trace.instant("retired", rid=req.rid,
                                   emitted=len(req.output))
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
        if self.obs.enabled:
            self.obs.trace.instant("verify_step", batch=len(decoding),
                                   drafted=sum(ks))
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

    _STEP_PHASE = "verify_step"

    def _step_counters(self):
        """The verify step's (signature, cost thunk, host bytes): every
        slot's window of spec_k + 1 rows runs (padding rows included);
        each live slot reads its blocks through its window's end. The
        proposer's drafting lands in the same phase."""
        bs = self.layout.block_size
        window = self.spec_k + 1
        slots = self.max_slots
        ctx = sum(paged.cdiv(r.prefill_pos + len(r.output) - 1 + window,
                             bs) * bs
                  for r in self.scheduler.decoding.values())
        # tokens, slots, pos0s and lengths up; packed [7, S * C] down
        return ((slots, window, ctx),
                lambda: self._costs.verify_step(slots, window, ctx),
                slots * window * 4 + 3 * slots * 4 + 7 * slots * window * 4)

    def metrics_registry(self) -> obs.MetricsRegistry:
        reg = super().metrics_registry()
        reg.gauge("acceptance_rate",
                  help="fraction of drafted tokens the target accepted"
                  ).set(self.acceptance_rate)
        reg.gauge("mean_accepted_length", unit="tokens",
                  help="tokens emitted per per-slot verify walk (the "
                       "measured side of predicted_spec_speedup)"
                  ).set(self.mean_accepted_length)
        return reg
