"""Prefix caching, session KV and the spill tier in the port
(``repro_torch.serving.prefix_cache`` / ``swap``): the cases of
tests/test_prefix_cache.py held inside the port, the trie's decisions
held to the reference's ``PrefixCache`` on the same operations, and the
bookkeeping of one request stream held to the reference engine's.

The parity contract (README, "PyTorch / H100 port"):

* prompt-prefix hits whose boundary is a chunk boundary of the cold run:
  tokens, logprobs and written pool leaves bitwise the cold run's, over
  bf16, int8 and fp8 pools (both runs prefill the same chunks at the same
  GEMM rows);
* other hits (a copy-on-write divergence mid-block, a repeated prompt):
  the warm run prefills the remainder at fewer GEMM rows. torch's CPU
  GEMM gives bitwise rows at these widths (measured: 0 distance in
  tokens, logprobs and every pool leaf, all three pools), so these are
  pinned bitwise too;
* session whole-history hits, where decode- or verify-written blocks
  serve a later prefill: bitwise on neither device. Decode and verify
  run the paged-attention formulation (its plain twin here), prefill
  runs flash attention in torch ops, and they round differently; from
  layer 1 on the difference travels through the hidden states. Held
  here: tokens equal, logprobs within ``SESSION_LOGPROB_TOL`` (measured
  at most 0.0116), layer 0's entries bitwise, later layers within
  ``SESSION_STEPS`` storage steps (measured 1.58 bf16, 4.0 int8, 0.75
  fp8; a step is the format's step times the row's max |value|).
"""

import random
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from _hypothesis_fallback import given, settings  # noqa: E402
from _hypothesis_fallback import strategies as st  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import common as rcommon  # noqa: E402
from repro.serving.engine import BlockAllocator as RefAllocator  # noqa: E402
from repro.serving.engine import DecodeEngine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.prefix_cache import PrefixCache as RefCache  # noqa: E402
from repro.serving.swap import PrefixSpill as RefSpill  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api, paged  # noqa: E402
from repro_torch.quant import core as qcore  # noqa: E402
from repro_torch.serving import (AllocatorError, BlockAllocator,  # noqa: E402
                                 DecodeEngine, Request, SpecDecodeEngine,
                                 SwapMissError)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serving.swap import PrefixSpill  # noqa: E402
from repro_torch.spec import DraftModelProposer, NGramProposer  # noqa: E402

MAX_CONTEXT, BLOCK, CHUNK = 64, 16, 32

SYS = [7, 3, 9, 1, 4, 4, 8, 2, 6, 5, 1, 9, 2, 8, 3, 7,
       5, 5, 2, 9, 6, 1, 7, 3, 8, 8, 4, 2, 9, 5, 6, 1]   # 2 full blocks

SESSION_LOGPROB_TOL = 0.05
SESSION_STEPS = 8.0
STORAGE_STEP = {"bf16": 2.0 ** -7, "int8": 1 / 127, "fp8": 1 / 8}


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _cfg(**kw):
    return t_reduced(t_get_config("qwen1.5-0.5b")).with_(num_layers=2, **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    return cfg, api.init_params(cfg, device="cpu", seed=0)


# -------------------------------------------------------------- helpers ----

def _slot_kv(engine, req) -> dict:
    """The pool data (every leaf and layer) the request cached: its blocks
    in table order, cut to the slot's cached length. Runs while the
    request still owns its slot."""
    n_tok = int(engine.caches["len"][0, req.slot])
    assert n_tok > 0
    out = {}
    for name in paged.POOL_KEYS:
        if name in engine.caches:
            g = engine.caches[name][:, req.blocks]
            g = g.reshape((g.shape[0], -1) + tuple(g.shape[3:]))
            out[name] = g[:, :n_tok].clone()
    return out


def _with_snapshots(base):
    class Snap(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.snapshots = {}

        def _on_retire(self, req):
            super()._on_retire(req)
            self.snapshots[req.rid] = _slot_kv(self, req)
    return Snap


SnapEngine = _with_snapshots(DecodeEngine)
SnapSpecEngine = _with_snapshots(SpecDecodeEngine)


def _assert_bitwise(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), f"pool mismatch at {k}"


def _assert_request_parity(warm_req, warm_eng, cold_req, cold_eng):
    """Tokens, logprobs and written pool leaves bitwise the cold run's."""
    assert warm_req.output == cold_req.output
    assert warm_req.logprobs == cold_req.logprobs        # exact floats
    _assert_bitwise(warm_eng.snapshots[warm_req.rid],
                    cold_eng.snapshots[cold_req.rid])


def _storage_steps(a: dict, e: dict, kv_dtype: str) -> list[float]:
    """Per layer: the largest |a - e| over the K/V entries (dequantized),
    in storage steps (the format's step times the row's max |value|)."""
    step = STORAGE_STEP[kv_dtype]
    worst = None
    for name, scale in (("kpool", "kscale"), ("vpool", "vscale")):
        x, y = qcore.cast_f32(a[name]), qcore.cast_f32(e[name])
        if scale in a:
            x, y = x * a[scale][..., None], y * e[scale][..., None]
        amax = y.abs().amax(dim=-1, keepdim=True)
        d = ((x - y).abs() / (step * amax + 1e-6)).flatten(1).amax(1)
        worst = d if worst is None else torch.maximum(worst, d)
    return [float(v) for v in worst]


def _assert_session_parity(w, warm, c, cold, kv_dtype):
    """The session contract: tokens equal, logprobs within the stated
    tolerance, layer 0 bitwise, later layers within SESSION_STEPS."""
    assert w.output == c.output
    np.testing.assert_allclose(w.logprobs, c.logprobs, rtol=0,
                               atol=SESSION_LOGPROB_TOL)
    a, e = warm.snapshots[w.rid], cold.snapshots[c.rid]
    assert set(a) == set(e)
    for k in a:
        assert torch.equal(a[k][0], e[k][0]), f"layer 0 differs at {k}"
    steps = _storage_steps(a, e, kv_dtype)
    assert max(steps) <= SESSION_STEPS, steps


def _engine(cfg, params, cls=SnapEngine, **kw):
    kw.setdefault("max_context", MAX_CONTEXT)
    kw.setdefault("block_size", BLOCK)
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("max_slots", 2)
    return cls(cfg, params, device="cpu", **kw)


def _run(engine, *reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()


# ------------------------------------------------------- parity suite ------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_hit_parity_bitwise(kv_dtype):
    """A caches SYS; B (greedy) and C (seeded sampling) hit it at a chunk
    boundary. Tokens, logprobs and written K/V / scales are bitwise the
    cold runs'."""
    cfg = _cfg(kv_dtype=kv_dtype)
    params = api.init_params(cfg, device="cpu", seed=0)

    def reqs():
        return [Request(rid=1, prompt=SYS + [11, 12, 13], max_new_tokens=5),
                Request(rid=2, prompt=SYS + [21, 22], max_new_tokens=5,
                        temperature=1.3, seed=9)]

    warm = _engine(cfg, params, prefix_cache=True)
    _run(warm, Request(rid=0, prompt=SYS + [41, 42], max_new_tokens=3))
    wb, wc = reqs()
    _run(warm, wb, wc)
    assert wb.prefix_hit == len(SYS) and wc.prefix_hit == len(SYS)
    cold = _engine(cfg, params)
    cb, cc = reqs()
    _run(cold, cb, cc)
    _assert_request_parity(wb, warm, cb, cold)
    _assert_request_parity(wc, warm, cc, cold)
    assert warm.kv_stats["prefix_hit_tokens"] == 2 * len(SYS)
    assert warm.kv_stats["prefix_saved_bytes"] == \
        2 * len(SYS) * warm.kv.token_bytes(2)
    # the hits skipped their cached tokens' prefill
    assert cold.kv_stats["prefill_tokens"] - \
        (warm.kv_stats["prefill_tokens"] - len(SYS) - 2) == 2 * len(SYS)
    assert warm.prefix_hit_rate == pytest.approx(
        2 * len(SYS) / (3 * len(SYS) + 7))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_spec_engine_hit_parity(setup, kv_dtype):
    """Hits under the speculative engine: n-gram drafts from the shared
    history, verify windows on shared tables, set_lens rollback; bitwise
    the cold spec run."""
    cfg = _cfg(kv_dtype=kv_dtype)
    params = api.init_params(cfg, device="cpu", seed=0)
    prompt = SYS + [5, 6, 5, 6, 5]

    def build(prefix_cache):
        return _engine(cfg, params, cls=SnapSpecEngine,
                       proposer=NGramProposer(), spec_k=3,
                       prefix_cache=prefix_cache)

    def reqs():
        return (Request(rid=1, prompt=prompt, max_new_tokens=8),
                Request(rid=2, prompt=prompt[:-1], max_new_tokens=6,
                        temperature=1.1, seed=4))

    warm = build(True)
    _run(warm, Request(rid=0, prompt=SYS + [41], max_new_tokens=3))
    wb, wc = reqs()
    _run(warm, wb, wc)
    assert wb.prefix_hit >= len(SYS)
    cold = build(False)
    cb, cc = reqs()
    _run(cold, cb, cc)
    _assert_request_parity(wb, warm, cb, cold)
    _assert_request_parity(wc, warm, cc, cold)


def test_spec_draft_model_replays_hit_prefix(setup):
    """The draft model has no prefix cache: on a hit it replays the cached
    span into its mirror, so its drafts equal the cold run's."""
    cfg, params = setup
    dcfg = cfg.with_(num_layers=1)
    dparams = api.init_params(dcfg, device="cpu", seed=1)

    def build(prefix_cache):
        return _engine(cfg, params, cls=SnapSpecEngine,
                       proposer=DraftModelProposer(dcfg, dparams),
                       spec_k=3, prefix_cache=prefix_cache)

    warm = build(True)
    _run(warm, Request(rid=0, prompt=SYS + [41], max_new_tokens=3))
    base = dict(warm.kv_stats)
    wb = Request(rid=1, prompt=SYS + [5, 6], max_new_tokens=6,
                 temperature=1.2, seed=11)
    _run(warm, wb)
    assert wb.prefix_hit == len(SYS)
    cold = build(False)
    cb = Request(rid=1, prompt=SYS + [5, 6], max_new_tokens=6,
                 temperature=1.2, seed=11)
    _run(cold, cb)
    _assert_request_parity(wb, warm, cb, cold)
    for key in ("spec_drafted", "spec_accepted"):
        assert warm.kv_stats[key] - base[key] == cold.kv_stats[key], key


def test_cow_mid_block_divergence(setup):
    """A prompt diverging inside block 1 gets a private copy of it; its
    remainder is prefilled at 4 GEMM rows against the cold run's 28, and
    is bitwise the cold run on the CPU all the same. The shared original
    serves a later full hit untouched."""
    cfg, params = setup
    warm = _engine(cfg, params, prefix_cache=True)
    _run(warm, Request(rid=0, prompt=SYS + [41], max_new_tokens=3))
    div = SYS[:24] + [99, 98, 97, 96]
    wb = Request(rid=1, prompt=div, max_new_tokens=5)
    _run(warm, wb)
    assert wb.prefix_hit == 24
    assert warm.kv_stats["prefix_cow_blocks"] == 1
    wc = Request(rid=2, prompt=SYS + [55, 56], max_new_tokens=4)
    _run(warm, wc)
    assert wc.prefix_hit == len(SYS)
    cold = _engine(cfg, params)
    cb = Request(rid=1, prompt=div, max_new_tokens=5)
    cc = Request(rid=2, prompt=SYS + [55, 56], max_new_tokens=4)
    _run(cold, cb, cc)
    _assert_request_parity(wb, warm, cb, cold)
    _assert_request_parity(wc, warm, cc, cold)


def test_identical_prompt_full_hit_cow(setup):
    """A repeated prompt hits all but its last token, which is re-scored
    (one GEMM row) in a copy of the last block: bitwise the cold run."""
    cfg, params = setup
    warm = _engine(cfg, params, prefix_cache=True)
    a = Request(rid=0, prompt=list(SYS), max_new_tokens=4)
    _run(warm, a)
    wb = Request(rid=1, prompt=list(SYS), max_new_tokens=4)
    _run(warm, wb)
    assert wb.prefix_hit == len(SYS) - 1
    assert warm.kv_stats["prefix_cow_blocks"] == 1
    assert wb.output == a.output and wb.logprobs == a.logprobs
    cold = _engine(cfg, params)
    cb = Request(rid=1, prompt=list(SYS), max_new_tokens=4)
    _run(cold, cb)
    _assert_request_parity(wb, warm, cb, cold)


def test_interleaved_hit_admission_during_decode(setup):
    """A hit admitted while another slot decodes prefills in chunks of 4
    between batched decode steps; the stray full-batch writes land in the
    request's own blocks, never the shared prefix."""
    cfg, params = setup
    warm = _engine(cfg, params, prefix_cache=True, prefill_chunk=4)
    _run(warm, Request(rid=0, prompt=SYS + [41], max_new_tokens=3))
    r1 = Request(rid=1, prompt=[1, 2, 3], max_new_tokens=12)
    warm.submit(r1)
    warm.step()
    warm.step()
    wb = Request(rid=2, prompt=SYS + [61, 62, 63], max_new_tokens=4)
    _run(warm, wb)
    assert wb.prefix_hit == len(SYS)
    cold = _engine(cfg, params, prefill_chunk=4)
    c1 = Request(rid=1, prompt=[1, 2, 3], max_new_tokens=12)
    cb = Request(rid=2, prompt=SYS + [61, 62, 63], max_new_tokens=4)
    cold.submit(c1)
    cold.step()
    cold.step()
    _run(cold, cb)
    assert r1.output == c1.output
    _assert_request_parity(wb, warm, cb, cold)
    wc = Request(rid=3, prompt=SYS + [71], max_new_tokens=3)
    _run(warm, wc)
    cc = Request(rid=3, prompt=SYS + [71], max_new_tokens=3)
    _run(cold, cc)
    _assert_request_parity(wc, warm, cc, cold)


# ------------------------------------------------- pressure / eviction -----

def test_oversubscribed_pool_evicts_not_livelocks(setup):
    cfg, params = setup
    engine = _engine(cfg, params, num_blocks=5, prefix_cache=True)
    p_shared = (SYS + SYS)[:40]
    reqs = [Request(rid=i, prompt=list(p_shared), max_new_tokens=8)
            for i in range(3)]
    other = Request(rid=9, prompt=[200 + i for i in range(40)],
                    max_new_tokens=8)
    again = Request(rid=10, prompt=list(p_shared), max_new_tokens=8)
    _run(engine, *reqs, other, again)
    assert all(r.done for r in reqs) and other.done and again.done
    assert engine.kv_stats["prefix_evicted_blocks"] >= 2
    assert reqs[1].output == reqs[0].output
    assert again.output == reqs[0].output
    with pytest.raises(ValueError):
        engine.submit(Request(rid=11, prompt=list(range(60)),
                              max_new_tokens=10))


def test_full_pool_request_with_cow_hit_degrades_not_livelocks(setup):
    cfg, params = setup
    engine = _engine(cfg, params, max_context=128, num_blocks=9,
                     prefix_cache=True)
    prompt = list(range(1, 113))
    a = Request(rid=0, prompt=prompt, max_new_tokens=16)
    _run(engine, a)
    assert a.done and engine.prefix_cache.num_nodes == 7
    b = Request(rid=1, prompt=list(prompt), max_new_tokens=16)
    _run(engine, b)
    assert b.done and b.output == a.output
    assert b.prefix_hit == 96


def test_eviction_races_just_admitted_hit(setup):
    cfg, params = setup
    engine = _engine(cfg, params, num_blocks=9, prefix_cache=True)
    _run(engine, Request(rid=0, prompt=SYS + [41], max_new_tokens=3),
         Request(rid=1, prompt=[150 + i for i in range(33)],
                 max_new_tokens=3))
    assert engine.prefix_cache.num_nodes == 4
    wb = Request(rid=2, prompt=SYS + [61, 62], max_new_tokens=5)
    c = Request(rid=3, prompt=[90 + i for i in range(48)], max_new_tokens=8)
    _run(engine, wb, c)
    assert wb.done and c.done and wb.prefix_hit == len(SYS)
    assert engine.kv_stats["prefix_evicted_blocks"] >= 1
    cold = _engine(cfg, params)
    cb = Request(rid=2, prompt=SYS + [61, 62], max_new_tokens=5)
    _run(cold, cb)
    _assert_request_parity(wb, engine, cb, cold)


def test_allocator_refcounts():
    a = BlockAllocator(num_blocks=6)
    x = a.alloc(2)
    assert [a.refcount(b) for b in x] == [1, 1]
    a.retain(x)
    a.release(x)
    assert a.num_free == 3 and all(a.refcount(b) == 1 for b in x)
    a.release(x)
    assert a.num_free == 5 and all(a.refcount(b) == 0 for b in x)
    with pytest.raises(AllocatorError):
        a.release(x)
    with pytest.raises(AllocatorError):
        a.retain([x[0]])


def test_knobs_validate_like_the_reference(setup):
    cfg, params = setup
    with pytest.raises(ValueError):
        _engine(cfg, params, spill_blocks=4)
    with pytest.raises(ValueError):
        _engine(cfg, params, prefix_cache=True, promote="sometimes")
    with pytest.raises(ValueError):
        _engine(cfg, params, preempt="random")
    # telemetry is served now, and shared with the prefix cache and its
    # spill tier
    tele = Telemetry()
    eng = _engine(cfg, params, prefix_cache=True, spill_blocks=2,
                  telemetry=tele)
    assert eng.obs is tele and eng.prefix_cache.obs is tele
    assert eng.prefix_cache.spill.obs is tele and eng.swap.obs is tele
    for mode in ("auto", "always", "never"):
        eng = _engine(cfg, params, prefix_cache=True, spill_blocks=2,
                      promote=mode, preempt="priority")
        assert eng.prefix_cache.spill.capacity == 2
    spec = _engine(cfg, params, cls=SpecDecodeEngine,
                   proposer=NGramProposer(), prefix_cache=True,
                   spill_blocks=2, preempt="lru")
    assert spec.prefix_cache is not None and spec.preempt_policy == "lru"


# ---------------------------------- trie decisions against the reference ----

_BS, _POOL, _MAX_NEW = 4, 13, 3
_STEM = [0, 1, 0, 1, 0, 0, 1, 1] * 2


class _Twin:
    """The port's and the reference's allocator + trie (+ spill tier)
    driven by the same operations; every decision is compared."""

    def __init__(self, spill: bool):
        self.alloc = BlockAllocator(_POOL)
        self.ralloc = RefAllocator(_POOL)
        self.cache = PrefixCache(self.alloc, _BS)
        self.ref = RefCache(self.ralloc, _BS)
        if spill:
            self.promoted = ([], [])
            for c, sp, log in ((self.cache, PrefixSpill, self.promoted[0]),
                               (self.ref, RefSpill, self.promoted[1])):
                c.spill = sp(6, lambda blocks: {
                    "k": np.zeros((1, len(blocks), _BS))})
                c.promote_fn = (lambda blocks, snaps, rid=None, log=log:
                                log.append(list(blocks)))
                c.promote_ratio = float("inf")
        self.live = []

    def same(self, a, b):
        assert a == b
        return a

    def check(self):
        assert self.cache.stats == self.ref.stats
        assert self.alloc._free == self.ralloc._free
        assert self.alloc._ref == self.ralloc._ref
        assert self.cache._clock == self.ref._clock
        nodes = _trie(self.cache)
        assert nodes == _trie(self.ref)
        assert self.alloc.num_free + self.alloc.num_held == _POOL - 1
        assert self.cache.num_nodes == len(nodes)
        if self.cache.spill is not None:
            sp, rsp = self.cache.spill, self.ref.spill
            assert list(sp._store) == list(rsp._store)
            assert sp.stats == rsp.stats
            assert self.promoted[0] == self.promoted[1]

    def admit(self, rng):
        n = rng.randrange(1, 17)
        prompt = _STEM[:n] if rng.random() < 0.6 else \
            [rng.randrange(2) for _ in range(n)]
        m, rm = self.cache.match(prompt), self.ref.match(prompt)
        assert (m.blocks, m.hit, m.cow_src) == (rm.blocks, rm.hit,
                                                rm.cow_src)
        for a in (self.alloc, self.ralloc):
            a.retain(m.blocks)
            if m.cow_src is not None:
                a.retain([m.cow_src])
        need = -(-(len(prompt) + _MAX_NEW) // _BS) - len(m.blocks)
        if need > self.alloc.num_free:
            self.same(self.cache.evict(need - self.alloc.num_free),
                      self.ref.evict(need - self.ralloc.num_free))
        if need > self.alloc.num_free:
            for a in (self.alloc, self.ralloc):
                a.release(m.blocks)
                if m.cow_src is not None:
                    a.release([m.cow_src])
            return
        fresh = self.same(self.alloc.alloc(need), self.ralloc.alloc(need))
        for a in (self.alloc, self.ralloc):
            if m.cow_src is not None:
                a.release([m.cow_src])
        for c in (self.cache, self.ref):
            c.note_admitted(m.hit, len(prompt), m.cow_src is not None)
        self.live.append((prompt, m.blocks + fresh))

    def retire(self):
        prompt, blocks = self.live.pop(0)
        for c, a in ((self.cache, self.alloc), (self.ref, self.ralloc)):
            c.insert(prompt, blocks)
            a.release(blocks)


def _trie(cache):
    """Every node as (path, block, last_used, seq), in a fixed order."""
    out, stack = [], [(cache.root, ())]
    while stack:
        node, path = stack.pop()
        for key in sorted(node.children):
            child = node.children[key]
            out.append((path + key, child.block, child.last_used,
                        child.seq))
            stack.append((child, path + key))
    return sorted(out)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=5),
                min_size=1, max_size=60),
       st.integers(min_value=0, max_value=2 ** 20))
def test_trie_decisions_match_reference(ops, seed):
    """Random admit / retire / evict interleavings: the port's matches,
    copy-on-write sources, evictions (count and victim order), allocator
    state, node clocks and stats equal the reference's at every step, and
    the pool accounting sums to capacity."""
    rng = random.Random(seed)
    t = _Twin(spill=False)
    for op in ops:
        if op <= 2:
            t.admit(rng)
        elif op <= 4 and t.live:
            t.retire()
        else:
            n = rng.randrange(1, 4)
            t.same(t.cache.evict(n), t.ref.evict(n))
        t.check()
    while t.live:
        t.retire()
        t.check()
    t.same(t.cache.evict(_POOL), t.ref.evict(_POOL))
    t.check()
    assert t.cache.num_nodes == 0 and t.alloc.num_free == _POOL - 1


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=7),
                min_size=1, max_size=60),
       st.integers(min_value=0, max_value=2 ** 20))
def test_spill_promote_decisions_match_reference(ops, seed):
    """The same with the spill tier armed: spilled keys (in LRU order),
    promoted chains (blocks handed to the restore), drops and host bytes
    equal the reference's at every step."""
    rng = random.Random(seed)
    t = _Twin(spill=True)
    for op in ops:
        if op <= 2:
            t.admit(rng)
        elif op <= 4 and t.live:
            t.retire()
        elif op <= 5:
            n = rng.randrange(1, 4)
            t.same(t.cache.evict(n), t.ref.evict(n))
        else:
            probe = _STEM[:rng.randrange(1, 17)]
            t.same(t.cache.promote(probe), t.ref.promote(probe))
        t.check()
        sp = t.cache.spill
        assert sp.stats["host_bytes"] == sum(sp._nbytes.values())
        assert len(sp) <= sp.capacity
    while t.live:
        t.retire()
        t.check()
    t.same(t.cache.evict(_POOL), t.ref.evict(_POOL))
    t.check()
    assert t.cache.num_nodes == 0 and t.alloc.num_free == _POOL - 1


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=2, max_value=9),
       st.integers(min_value=0, max_value=2 ** 20))
def test_trie_match_is_prefix_of_prompt(k, seed):
    rng = random.Random(seed)
    alloc = BlockAllocator(64)
    cache = PrefixCache(alloc, _BS)
    inserted = {}
    for _ in range(k):
        n = rng.randrange(1, 17)
        prompt = [rng.randrange(2) for _ in range(n)]
        blocks = alloc.alloc(-(-n // _BS))
        cache.insert(prompt, blocks)
        for i in range(n // _BS):
            inserted[blocks[i]] = tuple(prompt[i * _BS:(i + 1) * _BS])
        alloc.release(blocks)
    probe = [rng.randrange(2) for _ in range(rng.randrange(1, 17))]
    m = cache.match(probe)
    assert 0 <= m.hit <= max(len(probe) - 1, 0)
    assert len(m.blocks) == m.hit // _BS
    for i, b in enumerate(m.blocks):
        assert inserted[b] == tuple(probe[i * _BS:(i + 1) * _BS])
    if m.hit % _BS:
        span = inserted[m.cow_src]
        off = (m.hit // _BS) * _BS
        assert span[:m.hit - off] == tuple(probe[off:m.hit])
    else:
        assert m.cow_src is None


def test_match_clock_uniform_under_short_prompts():
    def build():
        alloc = BlockAllocator(16)
        cache = PrefixCache(alloc, 4)
        for p in ([1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]):
            blocks = alloc.alloc(1)
            cache.insert(p, blocks)
            alloc.release(blocks)
        return cache

    a, b = build(), build()
    for pa, pb in (([1], [77, 78, 79]), ([5, 6, 7, 8], [5, 6, 7, 8]),
                   ([0], [66, 67]), ([9, 10, 11, 12], [9, 10, 11, 12])):
        a.match(pa)
        b.match(pb)
    assert a._clock == b._clock

    def order(c):
        return [n.key for n in sorted(c._evictable_leaves(),
                                      key=lambda n: (n.last_used, n.seq))]
    assert order(a) == order(b) and order(a)[0] == (1, 2, 3, 4)


# ---------------------------------------------------------- session KV -----

def _conversation(eng, rid0=100, turn_tokens=((41, 42), (51, 52, 53), (61,)),
                  max_new=(15, 5, 4), temps=(0.0, 0.0, 0.0)):
    hist = list(SYS)
    reqs = []
    for i, (extra, mn, tp) in enumerate(zip(turn_tokens, max_new, temps)):
        r = Request(rid=rid0 + i, prompt=hist + list(extra),
                    max_new_tokens=mn, temperature=tp,
                    seed=7 + i if tp > 0 else 0)
        _run(eng, r)
        assert r.done
        hist = r.prompt + r.output
        reqs.append(r)
    return reqs


def _replay_cold(cfg, params, warm_reqs, cls=SnapEngine, **kw):
    cold = _engine(cfg, params, cls=cls, **kw)
    out = []
    for w in warm_reqs:
        c = Request(rid=w.rid, prompt=list(w.prompt),
                    max_new_tokens=w.max_new_tokens,
                    temperature=w.temperature, seed=w.seed)
        _run(cold, c)
        out.append(c)
    return cold, out


def test_session_whole_history_hit(setup):
    """Turn t + 1 hits every full block of turn t's whole history, the
    decode-written block included; session_kv=False caches prompts only."""
    cfg, params = setup
    eng = _engine(cfg, params, prefix_cache=True)
    t1, t2, t3 = _conversation(eng)
    assert t2.prefix_hit == 48 > len(t1.prompt)
    assert t3.prefix_hit == 48
    assert eng.prefix_cache.stats["hit_tokens"] == 96
    legacy = _engine(cfg, params, prefix_cache=True, session_kv=False)
    l1, l2, _ = _conversation(legacy)
    assert l2.prefix_hit == (len(l1.prompt) // BLOCK) * BLOCK == 32


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_session_warm_vs_cold_parity(kv_dtype):
    """A 3-turn conversation (turn 2 sampled) against the cold runs of the
    same teacher-forced prompts: turn 1 bitwise; turns 2 and 3 read a
    decode-written block through prefill, under the session contract of
    the module docstring."""
    cfg = _cfg(kv_dtype=kv_dtype)
    params = api.init_params(cfg, device="cpu", seed=0)
    warm = _engine(cfg, params, prefix_cache=True)
    wreqs = _conversation(warm, temps=(0.0, 1.2, 0.0))
    assert wreqs[1].prefix_hit == 48
    cold, creqs = _replay_cold(cfg, params, wreqs)
    _assert_request_parity(wreqs[0], warm, creqs[0], cold)
    for w, c in zip(wreqs[1:], creqs[1:]):
        _assert_session_parity(w, warm, c, cold, kv_dtype)


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
def test_session_parity_spec_engines(setup, proposer):
    """Session KV under both proposers: turn 1's 14 tokens fill block 2
    with verify-written entries, which turn 2's prefill reads."""
    cfg, params = setup
    if proposer == "ngram":
        def make():
            return NGramProposer()
    else:
        dcfg = cfg.with_(num_layers=1)
        dparams = api.init_params(dcfg, device="cpu", seed=1)

        def make():
            return DraftModelProposer(dcfg, dparams)
    kw = dict(cls=SnapSpecEngine, spec_k=3)
    warm = _engine(cfg, params, prefix_cache=True, proposer=make(), **kw)
    wreqs = _conversation(warm, turn_tokens=((5, 6, 5, 6), (5, 6), (6, 5)),
                          max_new=(14, 5, 4))
    assert wreqs[1].prefix_hit == 48
    cold, creqs = _replay_cold(cfg, params, wreqs, proposer=make(), **kw)
    _assert_request_parity(wreqs[0], warm, creqs[0], cold)
    for w, c in zip(wreqs[1:], creqs[1:]):
        _assert_session_parity(w, warm, c, cold, "bf16")


# ------------------------------------------------- spill tier / promote ----

def _spilled_turns(cfg, params, promote, num_blocks=6):
    eng = _engine(cfg, params, prefix_cache=True, num_blocks=num_blocks,
                  spill_blocks=8, promote=promote)
    t1 = Request(rid=0, prompt=SYS + [41, 42], max_new_tokens=15)
    _run(eng, t1)
    assert eng.prefix_cache.num_nodes == 3
    _run(eng, Request(rid=1, prompt=[200 + i for i in range(48)],
                      max_new_tokens=2))
    assert eng.kv_stats["prefix_spilled_blocks"] >= 1
    t2 = Request(rid=2, prompt=t1.prompt + t1.output + [51, 52],
                 max_new_tokens=3)
    return eng, t2


def test_session_spill_promote_roundtrip(setup):
    """Eviction spills the conversation's decode-written block to host;
    the next turn promotes it back into a fresh block, bitwise its
    snapshot, and emits bitwise what an engine emits with the block never
    evicted (the same content, read by the same formulation)."""
    cfg, params = setup
    warm, t2 = _spilled_turns(cfg, params, "always", num_blocks=7)
    assert len(warm.prefix_cache.spill) >= 1
    spilled = {k: {n: t.clone() for n, t in v.items()}
               for k, v in warm.prefix_cache.spill._store.items()}
    restored = []
    promote_fn = warm.prefix_cache.promote_fn

    def recording(blocks, snaps):
        promote_fn(blocks, snaps)
        restored.append(paged.extract_blocks(warm.caches, blocks))
    warm.prefix_cache.promote_fn = recording
    _run(warm, t2)
    assert warm.kv_stats["prefix_promoted_blocks"] >= 1
    assert t2.prefix_hit >= warm.kv_stats["prefix_promoted_tokens"] > 0
    # promoted blocks are bitwise their spilled snapshots
    promoted_keys = [k for k in spilled
                     if k not in warm.prefix_cache.spill._store]
    want = paged.concat_block_snapshots([spilled[k] for k in promoted_keys])
    (got,) = restored
    _assert_bitwise(got, want)
    sp = warm.prefix_cache.spill.stats
    assert sp["promoted_bytes_total"] > 0
    assert sp["host_bytes"] == sum(warm.prefix_cache.spill._nbytes.values())
    # the same conversation on a pool large enough that nothing spills
    roomy = _engine(cfg, params, prefix_cache=True)
    r1 = Request(rid=0, prompt=SYS + [41, 42], max_new_tokens=15)
    _run(roomy, r1)
    _run(roomy, Request(rid=1, prompt=[200 + i for i in range(48)],
                        max_new_tokens=2))
    r2 = Request(rid=2, prompt=list(t2.prompt), max_new_tokens=3)
    _run(roomy, r2)
    assert r2.prefix_hit == t2.prefix_hit == 48
    assert r2.output == t2.output and r2.logprobs == t2.logprobs
    _assert_bitwise(warm.snapshots[2], roomy.snapshots[2])


def test_session_promote_gate_never_degrades(setup):
    """promote='never': the spilled span is prefilled cold, requests still
    complete, the host tier is never consulted; the stream equals the
    promoting engine's up to the session contract (the promoted engine
    reads decode-written blocks, the never engine prefills them)."""
    cfg, params = setup
    eng, t2 = _spilled_turns(cfg, params, "never")
    _run(eng, t2)
    assert t2.done and eng.kv_stats["prefix_promoted_blocks"] == 0
    promoted, p2 = _spilled_turns(cfg, params, "always")
    _run(promoted, p2)
    assert promoted.kv_stats["prefix_promoted_blocks"] >= 1
    assert p2.output == t2.output
    np.testing.assert_allclose(p2.logprobs, t2.logprobs, rtol=0,
                               atol=SESSION_LOGPROB_TOL)


def test_promote_gate_auto_prices_the_h100(setup):
    """'auto' evaluates the H100 forecast on the engine's geometry: the
    reduced test model is far below the crossover, and so is full-width
    qwen1.5 now that re-prefill is priced at the bf16 tensor cores'
    989 TFLOP/s (0.6335: re-prefill wins, nothing is promoted)."""
    from repro_torch.ecm.hopper import predicted_restore_vs_reprefill
    from repro_torch.ecm.machines import H100_SXM
    cfg, params = setup
    eng = _engine(cfg, params, prefix_cache=True, spill_blocks=4,
                  promote="auto")
    want = predicted_restore_vs_reprefill(
        BLOCK, eng.kv.token_bytes(2), 2 * api.num_params(params))
    assert eng.prefix_cache.promote_ratio == want < 1.0
    assert eng.prefix_cache.promote(SYS) == 0
    full = t_get_config("qwen1.5-0.5b")
    kv = api.KVCache.build(full, max_context=1024, max_slots=8)
    assert kv.token_bytes(8) == 98304
    n = sum(int(np.prod(s)) for s in _shapes(api.schema(full)))
    ratio = predicted_restore_vs_reprefill(16, kv.token_bytes(8), 2 * n)
    assert ratio < 1.0 and ratio == pytest.approx(0.6335, abs=1e-4)
    assert ratio == pytest.approx(
        2 * n / H100_SXM["peak_flops"]
        / (98304 / H100_SXM["host_link_bw"]))


def _shapes(schema):
    if isinstance(schema, dict):
        for v in schema.values():
            yield from _shapes(v)
    else:
        yield schema.shape


def test_spill_tier_capacity_drops_lru():
    def snap_fn(blocks):
        return {"k": np.zeros((1, len(blocks), 4))}
    tier = PrefixSpill(2, snap_fn)
    tier.put((1, 2, 3, 4), 0)
    tier.put((1, 2, 3, 4, 5, 6, 7, 8), 1)
    tier.put((9, 9, 9, 9), 2)
    assert len(tier) == 2 and (1, 2, 3, 4) not in tier
    assert tier.stats["dropped_blocks"] == 1
    assert tier.stats["host_bytes"] == sum(tier._nbytes.values())
    tier.put((9, 9, 9, 9), 3)
    assert len(tier) == 2 and tier.stats["spilled_blocks"] == 4
    with pytest.raises(SwapMissError):
        tier.take((7, 7, 7, 7))
    with pytest.raises(ValueError):
        PrefixSpill(0, snap_fn)


# ------------------------------------- bookkeeping against the reference ----

def test_bookkeeping_matches_reference_engine():
    """One request stream through the reference engine and the port's on
    the same bridged parameters: prefix hits, copy-on-write, eviction
    under a small pool, preemption and session inserts. The streams agree
    on these prompts, and with them every bookkeeping decision."""
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(num_layers=2,
                                                     num_kv_heads=2)
    # weights whose greedy streams agree across the two stacks on these
    # prompts (top-2 margins of ~0.01 flip some streams on other seeds)
    params = rcommon.init_params(rapi.schema(cfg), jax.random.key(1))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    prompts = [SYS + [41, 42], SYS + [11, 12, 13], SYS[:24] + [99, 98],
               [200 + i for i in range(40)], SYS + [41, 42, 5],
               list(SYS), [150 + i for i in range(20)]]
    runs = []
    for engine_cls, req_cls, p, c in ((RefEngine, RefRequest, params, cfg),
                                      (DecodeEngine, Request, tparams,
                                       _cfg(num_kv_heads=2))):
        kw = dict(max_slots=3, max_context=MAX_CONTEXT, block_size=BLOCK,
                  prefill_chunk=CHUNK, num_blocks=10, prefix_cache=True,
                  preempt="lru")
        if engine_cls is DecodeEngine:
            kw["device"] = "cpu"
        eng = engine_cls(c, p, **kw)
        reqs = [req_cls(rid=i, prompt=list(pr), max_new_tokens=12)
                for i, pr in enumerate(prompts)]
        for r in reqs[:3]:
            eng.submit(r)
        eng.run_until_done()
        for r in reqs[3:]:
            eng.submit(r)
        eng.run_until_done()
        keys = ("prefix_hit_tokens", "prefix_cow_blocks",
                "prefix_evicted_blocks", "prefix_promoted_blocks",
                "preempted", "preempted_blocks", "restored_blocks",
                "prefill_tokens", "decode_steps")
        runs.append(([r.output for r in reqs], [r.prefix_hit for r in reqs],
                     {k: eng.kv_stats[k] for k in keys},
                     eng.prefix_cache.num_nodes,
                     eng.scheduler.allocator.num_free))
    assert runs[0][0] == runs[1][0]          # the streams agree
    assert runs[0][1:] == runs[1][1:]
    hits, stats = runs[1][1], runs[1][2]
    assert any(h % BLOCK for h in hits)      # a copy-on-write hit ran
    assert stats["prefix_evicted_blocks"] and stats["preempted"]
