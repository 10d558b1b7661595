"""Fault tolerance in the port: ``FaultInjector`` decisions bitwise against
the reference's over a (seed, site, step) grid, ``paged.poison_blocks``
against the reference's on bridged pools, fault-injected runs against
the reference engine (the sweep of tests/test_faults.py:565, preempting
and prefix-caching, among them), the restore-vs-reprefill forecast
against the reference's function, and the cases of tests/test_faults.py
mirrored inside the port: preemption to host with bitwise restores over
bf16, int8 and fp8 pools and under both spec proposers, the ``lru`` and
``priority`` policies, cancellation while preempted, the ``KVSwap``
round trip and its symmetric ``SwapMissError``.

The injector is a host rule over keyed scalar draws, so its decisions
are equal bit for bit. Engine outputs inside the port are compared with
a fresh unperturbed port engine, as the reference's tests do.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import api, common, paged  # noqa: E402
from repro.serving.engine import DecodeEngine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.faults import FailoverServer as RefFailover  # noqa: E402
from repro.serving.faults import FaultInjector as RefInjector  # noqa: E402
from repro.serving.faults import FaultSpec as RefSpec  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import paged as tpaged  # noqa: E402
from repro_torch.serving import (AdmissionError, AllocatorError,  # noqa: E402
                                 DecodeEngine, FailoverServer, FaultInjector,
                                 FaultSpec, KVSwap, Request, ServingError,
                                 SpecDecodeEngine, StallError,
                                 SwapMissError, degraded_engine)
from repro_torch.spec import DraftModelProposer, NGramProposer  # noqa: E402

MAX_CONTEXT, BLOCK, CHUNK = 64, 16, 32


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _tcfg(**kw):
    return t_reduced(t_get_config("qwen1.5-0.5b")).with_(**kw)


@pytest.fixture(scope="module")
def setup():
    cfg = _tcfg()
    return cfg, tapi.init_params(cfg, device="cpu", seed=0)


def _engine(cfg, params, klass=DecodeEngine, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_context", MAX_CONTEXT)
    kw.setdefault("block_size", BLOCK)
    kw.setdefault("prefill_chunk", CHUNK)
    return klass(cfg, params, device="cpu", **kw)


def _reference(cfg, params, prompt, n_new, **kw):
    """A fresh unperturbed engine running the request solo."""
    engine = _engine(cfg, params, **kw)
    req = Request(rid=999, prompt=list(prompt), max_new_tokens=n_new)
    engine.submit(req)
    engine.run_until_done()
    assert req.done
    return req, engine


# ------------------------------------------------- vs the reference -------

def test_injector_decisions_match_reference():
    """fire / choose over a (seed, site, step) grid, with rate, step and
    one-shot specs: the same decisions, victims and logs."""
    for seed in (0, 11, 2 ** 31 + 3):
        specs = [dict(site="logit_nan", rate=0.3),
                 dict(site="alloc_fail", rate=0.55),
                 dict(site="kv_corrupt", step=7),
                 dict(site="proposer_stall")]
        ours = FaultInjector(seed, [FaultSpec(**s) for s in specs])
        ref = RefInjector(seed, [RefSpec(**s) for s in specs])
        for step in range(1, 40):
            for site in FaultInjector.SITES:
                fired = ours.fire(site, step)
                assert fired == ref.fire(site, step), (seed, site, step)
                for n in (1, 3, 1000):
                    assert ours.choose(site, step, n) == \
                        ref.choose(site, step, n), (seed, site, step, n)
        assert ours.log == ref.log
        assert any(s == "logit_nan" for _, s, _ in ours.log)


def _ref_pools(cfg, rng):
    kv = api.KVCache.build(cfg, max_context=MAX_CONTEXT, block_size=BLOCK,
                           max_slots=2)
    caches = []
    for stack in kv.init(2):
        out = {}
        for k, v in stack.items():
            a = np.asarray(v)
            if k in paged.POOL_KEYS:
                if a.dtype == np.int8:
                    a = rng.integers(-127, 128, a.shape).astype(np.int8)
                else:
                    a = rng.normal(size=a.shape).astype(a.dtype)
            out[k] = a
        caches.append(out)
    return tuple(caches)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_poison_blocks_matches_reference(kv_dtype):
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(num_layers=2,
                                                     kv_dtype=kv_dtype)
    caches = _ref_pools(cfg, np.random.default_rng(0))
    port = bridge.caches_from_reference(caches, device="cpu")
    blocks = [1, 3]
    want = paged.poison_blocks(tuple({k: jax.numpy.asarray(v)
                                      for k, v in c.items()}
                                     for c in caches), blocks)[0]
    tpaged.poison_blocks(port, blocks)
    for k, v in want.items():
        w = np.asarray(v)
        g = port[k]
        if w.dtype.itemsize == 1:   # int8, and fp8 stored as e4m3 bytes
            np.testing.assert_array_equal(
                g.numpy().view(np.uint8), w.view(np.uint8), err_msg=k)
        else:
            np.testing.assert_array_equal(bridge.to_numpy(g),
                                          w.astype(np.float32), err_msg=k)
    poisoned = [k for k in want if k in paged.POOL_KEYS
                and np.isnan(np.asarray(want[k], np.float32)).any()]
    assert poisoned                           # the floats took the NaN


def test_fault_run_matches_reference_engine():
    """One injected run on both stacks from the reference's weights: the
    same (step, site, victim) log, the same quarantines and retries, and
    the same streams."""
    seed = 3
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(num_layers=2,
                                                     num_kv_heads=2)
    params = common.init_params(api.schema(cfg), jax.random.key(seed))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    specs = [dict(site="logit_nan", step=3), dict(site="alloc_fail", step=1),
             dict(site="kv_corrupt", step=6)]
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 8]]
    runs = []
    for klass, inj, req, server, p in (
            (RefEngine, RefInjector, RefRequest, RefFailover, params),
            (DecodeEngine, FaultInjector, Request, FailoverServer,
             tparams)):
        injector = inj(5, [(RefSpec if inj is RefInjector else FaultSpec)(
            **s) for s in specs])
        kw = dict(max_slots=2, max_context=MAX_CONTEXT, block_size=BLOCK,
                  prefill_chunk=CHUNK, fault_injector=injector)
        if klass is DecodeEngine:
            engine = klass(_tcfg(num_kv_heads=2), p, device="cpu", **kw)
        else:
            engine = klass(cfg, p, **kw)
        srv = server(engine)
        reqs = [req(rid=i, prompt=pr, max_new_tokens=8)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_done(max_steps=200)
        runs.append((injector.log, [r.output for r in reqs],
                     [(r.rid, r.state, r.retries) for r in reqs],
                     sorted(r.rid for r in srv.retried),
                     engine.kv_stats["guard_trips"]))
    assert runs[0] == runs[1]
    assert runs[1][3]                         # something was retried


# ------------------------------------------------- inside the port --------

def test_exception_hierarchy():
    assert issubclass(AllocatorError, ServingError)
    assert issubclass(AllocatorError, RuntimeError)
    assert issubclass(AdmissionError, ServingError)
    assert issubclass(AdmissionError, ValueError)
    e = StallError("stuck", [{"rid": 0, "state": "waiting"}])
    assert e.diagnostics[0]["rid"] == 0
    assert isinstance(e, ServingError)


def test_submit_rejects_bad_deadline(setup):
    cfg, params = setup
    engine = _engine(cfg, params)
    with pytest.raises(AdmissionError):
        engine.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=4,
                              deadline_steps=0))


def test_run_until_done_raises_stall_with_diagnostics(setup):
    cfg, params = setup
    engine = _engine(cfg, params)
    req = Request(rid=7, prompt=[1, 2, 3], max_new_tokens=12)
    engine.submit(req)
    with pytest.raises(StallError) as e:
        engine.run_until_done(max_steps=2)
    (diag,) = e.value.diagnostics
    assert diag["rid"] == 7 and diag["state"] == "decoding"
    assert diag["blocks_held"] >= 1 and diag["emitted"] >= 1
    assert engine.kv_stats["stalled_requests"] == 1
    engine.run_until_done()
    assert req.done


def test_injected_alloc_failure_recovers(setup):
    """An allocator fault at admission: the queue head waits one step and
    admits on the retry."""
    cfg, params = setup
    inj = FaultInjector(0, [FaultSpec(site="alloc_fail")])
    engine = _engine(cfg, params, fault_injector=inj)
    ref, _ = _reference(cfg, params, [5, 9, 11], 6)
    req = Request(rid=0, prompt=[5, 9, 11], max_new_tokens=6)
    engine.submit(req)
    engine.run_until_done()
    assert req.done and req.output == ref.output
    assert engine.kv_stats["alloc_faults"] == 1
    assert [s for _, s, _ in inj.log] == ["alloc_fail"]


def test_cancel_everywhere_releases_everything(setup):
    cfg, params = setup
    engine = _engine(cfg, params, max_slots=2)
    keep = Request(rid=0, prompt=[1, 2, 3], max_new_tokens=8)
    victim = Request(rid=1, prompt=[4, 5], max_new_tokens=8)
    queued = Request(rid=2, prompt=[6, 7], max_new_tokens=8)
    for r in (keep, victim, queued):
        engine.submit(r)
    engine.step()
    assert engine.cancel(1) and engine.cancel(2)
    assert not engine.cancel(99)
    assert victim.state == "cancelled" and queued.state == "cancelled"
    assert victim.blocks == [] and victim.slot is None
    engine.run_until_done()
    assert keep.done
    ref, _ = _reference(cfg, params, [1, 2, 3], 8)
    assert keep.output == ref.output
    np.testing.assert_allclose(keep.logprobs, ref.logprobs, rtol=1e-5,
                               atol=1e-5)
    alloc = engine.scheduler.allocator
    assert alloc.num_free == engine.kv.num_blocks - 1
    assert engine.kv_stats["cancelled"] == 2
    # cancel_all empties the engine from any state
    for i in range(3):
        engine.submit(Request(rid=10 + i, prompt=[1, 2 + i],
                              max_new_tokens=8))
    engine.step()
    assert engine.cancel_all() == 3 and not engine.num_unfinished
    assert alloc.num_free == engine.kv.num_blocks - 1


def test_deadline_expires_overrunning_request(setup):
    cfg, params = setup
    engine = _engine(cfg, params, max_slots=2)
    slow = Request(rid=0, prompt=[1, 2], max_new_tokens=12,
                   deadline_steps=4)
    fast = Request(rid=1, prompt=[3, 4], max_new_tokens=3)
    engine.submit(slow)
    engine.submit(fast)
    engine.run_until_done()
    assert fast.done
    assert not slow.done and slow.state == "expired"
    assert 0 < len(slow.output) < 12
    assert slow.blocks == [] and slow.slot is None
    assert engine.kv_stats["expired"] == 1
    alloc = engine.scheduler.allocator
    assert alloc.num_free == engine.kv.num_blocks - 1


def test_logit_nan_quarantine_and_failover(setup):
    """An injected NaN row trips the guard; the victim is quarantined and
    the FailoverServer finishes it on the degraded bf16 tier; the
    neighbour's stream stays intact."""
    cfg, params = setup
    inj = FaultInjector(3, [FaultSpec(site="logit_nan", step=3)])
    engine = _engine(cfg.with_(kv_dtype="fp8"), params, fault_injector=inj)
    server = FailoverServer(engine)
    a = Request(rid=0, prompt=[1, 2, 3], max_new_tokens=8)
    b = Request(rid=1, prompt=[4, 5, 6], max_new_tokens=8)
    server.submit(a)
    server.submit(b)
    server.run_until_done(max_steps=200)
    assert a.done and b.done
    assert engine.kv_stats["guard_trips"] == 1
    assert len(server.retried) == 1 and not server.failed
    victim = server.retried[0]
    assert victim.retries == 1 and "nonfinite" in victim.error
    assert server.degraded.cfg.kv_dtype == "bf16"
    assert server.degraded.device == engine.device
    for r in (a, b):
        ref, _ = _reference(cfg.with_(kv_dtype="fp8"), params, r.prompt, 8)
        if r is victim:
            ref, _ = _reference(cfg, params, r.prompt, 8)     # bf16 rerun
        assert r.output == ref.output


def test_kv_corrupt_quarantine_scrubs_blocks(setup):
    """A poisoned KV block NaNs the victim's logits; quarantine zeroes its
    private blocks, so the next owner of those blocks matches its
    reference."""
    cfg, params = setup
    inj = FaultInjector(1, [FaultSpec(site="kv_corrupt", step=2)])
    engine = _engine(cfg, params, max_slots=1, fault_injector=inj)
    victim = Request(rid=0, prompt=[5, 9, 11], max_new_tokens=8)
    engine.submit(victim)
    engine.run_until_done()
    assert not victim.done and victim.state == "quarantined"
    assert engine.kv_stats["guard_trips"] == 1
    assert [s for _, s, _ in inj.log] == ["kv_corrupt"]
    after = Request(rid=1, prompt=[2, 7, 1], max_new_tokens=6)
    engine.submit(after)
    engine.run_until_done()
    ref, _ = _reference(cfg, params, [2, 7, 1], 6, max_slots=1)
    assert after.output == ref.output and after.logprobs == ref.logprobs


def test_proposer_stall_degrades_to_plain_decode(setup):
    cfg, params = setup
    inj = FaultInjector(0, [FaultSpec(site="proposer_stall", step=2)])
    engine = _engine(cfg, params, SpecDecodeEngine,
                     proposer=NGramProposer(), spec_k=2,
                     fault_injector=inj)
    prompt = [3, 1, 4, 1, 5, 3, 1, 4]
    req = Request(rid=0, prompt=prompt, max_new_tokens=8)
    engine.submit(req)
    engine.run_until_done()
    assert req.done
    assert engine.kv_stats["proposer_stalls"] == 1
    ref, _ = _reference(cfg, params, prompt, 8, klass=SpecDecodeEngine,
                        proposer=NGramProposer(), spec_k=2)
    assert req.output == ref.output and req.logprobs == ref.logprobs


def _injection_log(seed, cfg, params):
    inj = FaultInjector(seed, [FaultSpec(site="logit_nan", rate=0.3),
                               FaultSpec(site="alloc_fail", rate=0.3)])
    engine = _engine(cfg, params, fault_injector=inj)
    server = FailoverServer(engine)
    for i in range(3):
        server.submit(Request(rid=i, prompt=[10 + i, 20 + i],
                              max_new_tokens=5))
    server.run_until_done(max_steps=300)
    return inj.log


def test_fault_injection_replays_bitwise(setup):
    cfg, params = setup
    log_a = _injection_log(11, cfg, params)
    assert log_a == _injection_log(11, cfg, params)
    assert log_a
    assert _injection_log(12, cfg, params) != log_a


def test_injector_rejects_unknown_site():
    with pytest.raises(ValueError):
        FaultInjector(0, [FaultSpec(site="cosmic_ray")])


def test_degraded_engine_follows_the_primary(setup):
    cfg, params = setup
    primary = _engine(cfg.with_(kv_dtype="int8"), params, max_slots=3)
    tier = degraded_engine(primary)
    assert isinstance(tier, DecodeEngine)
    assert not isinstance(tier, SpecDecodeEngine)
    assert tier.cfg.kv_dtype == "bf16" and tier.device.type == "cpu"
    assert tier.max_slots == 3 and tier.layout == primary.layout
    assert tier.injector is None and tier.guard is primary.guard


def test_deterministic_fault_sweep_completes_all_survivors(setup):
    """Every site armed over a pressured spec engine with sampled and
    greedy requests, plus one cancellation: every other request finishes
    (quarantined work on the failover tier), with no crash."""
    cfg, params = setup
    inj = FaultInjector(0, [FaultSpec(site=s)
                            for s in FaultInjector.SITES])
    engine = _engine(cfg, params, SpecDecodeEngine,
                     proposer=NGramProposer(), spec_k=2, max_slots=3,
                     num_blocks=9, preempt="lru", prefix_cache=True,
                     fault_injector=inj)
    server = FailoverServer(engine)
    sys_prompt = [101, 102, 103, 104]
    reqs = [Request(rid=i, prompt=sys_prompt + [i + 1, 2 * i + 1],
                    max_new_tokens=6, temperature=0.9 * (i % 2), seed=i)
            for i in range(5)]
    for r in reqs:
        server.submit(r)
    for _ in range(3):
        server.step()
    cancelled = reqs[4]
    assert engine.cancel(4) or server.degraded and \
        server.degraded.cancel(4)
    server.run_until_done(max_steps=500)
    fired = sorted({s for _, s, _ in inj.log})
    assert fired == sorted(FaultInjector.SITES)
    survivors = [r for r in reqs if r is not cancelled]
    assert all(r.done for r in survivors), [
        (r.rid, r.state) for r in survivors]
    assert not cancelled.done and cancelled.state == "cancelled"
    assert not server.failed
    assert engine.kv_stats["guard_trips"] >= 1
    assert engine.kv_stats["alloc_faults"] >= 1
    assert engine.kv_stats["proposer_stalls"] >= 1
    # only the trie holds blocks at the end, one per node
    alloc = engine.scheduler.allocator
    assert alloc.num_held == engine.prefix_cache.num_nodes
    assert len(engine.swap) == 0


def test_fault_sweep_matches_reference_engine():
    """The sweep of tests/test_faults.py:565 (every site armed over a
    pressured, preempting, prefix-caching spec engine, one cancellation)
    on both stacks from the reference's weights: the same (step, site,
    victim) log, states, retries, streams and bookkeeping."""
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(num_layers=2,
                                                     num_kv_heads=2)
    params = common.init_params(api.schema(cfg), jax.random.key(0))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    from repro.serving.engine import SpecDecodeEngine as RefSpecEngine
    from repro.spec import NGramProposer as RefNGram
    runs = []
    for klass, inj_cls, spec_cls, req_cls, srv_cls, prop, p, c in (
            (RefSpecEngine, RefInjector, RefSpec, RefRequest, RefFailover,
             RefNGram, params, cfg),
            (SpecDecodeEngine, FaultInjector, FaultSpec, Request,
             FailoverServer, NGramProposer, tparams,
             _tcfg(num_kv_heads=2))):
        inj = inj_cls(0, [spec_cls(site=s) for s in FaultInjector.SITES])
        kw = dict(proposer=prop(), spec_k=2, max_slots=3,
                  max_context=MAX_CONTEXT, block_size=BLOCK,
                  prefill_chunk=CHUNK, num_blocks=9, preempt="lru",
                  prefix_cache=True, fault_injector=inj)
        if klass is SpecDecodeEngine:
            kw["device"] = "cpu"
        engine = klass(c, p, **kw)
        server = srv_cls(engine)
        reqs = [req_cls(rid=i, prompt=[101, 102, 103, 104, i + 1, 2 * i + 1],
                        max_new_tokens=6) for i in range(5)]
        for r in reqs:
            server.submit(r)
        for _ in range(3):
            server.step()
        assert engine.cancel(4)
        server.run_until_done(max_steps=500)
        keys = ("guard_trips", "alloc_faults", "proposer_stalls",
                "preempted", "prefix_hit_tokens", "prefix_cow_blocks")
        runs.append((inj.log, [r.output for r in reqs],
                     [(r.rid, r.state, r.retries, r.prefix_hit)
                      for r in reqs],
                     {k: engine.kv_stats[k] for k in keys},
                     engine.prefix_cache.num_nodes))
    assert runs[0] == runs[1]
    assert sorted({s for _, s, _ in runs[1][0]}) == \
        sorted(FaultInjector.SITES)


# ------------------------------------------------ preemption to host ------


def _run_with_preemption(cfg, params, klass=DecodeEngine, *, prompt,
                         n_new, preempt_after=2, **kw):
    """A solo request preempted mid-decode and restored; a filler request
    churns the freed blocks in between, so a restore of stale content or
    of the wrong ids cannot pass by accident."""
    engine = _engine(cfg, params, klass, **kw)
    req = Request(rid=0, prompt=list(prompt), max_new_tokens=n_new)
    engine.submit(req)
    for _ in range(preempt_after):
        engine.step()
    assert not req.done and len(req.output) >= 1
    engine.preempt(0)
    assert req.state == "preempted" and req.slot is None
    assert req.blocks == [] and engine.swap.holds(0)
    filler = Request(rid=1, prompt=[9, 8, 7], max_new_tokens=4)
    engine.submit(filler)
    engine.run_until_done()
    assert req.done and filler.done and not engine.swap.holds(0)
    assert engine.kv_stats["preempted"] == 1
    assert engine.kv_stats["restored_blocks"] >= 1
    return req, engine


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_preempt_restore_bitwise_parity(setup, kv_dtype, record_blocks):
    """A preempted and restored request equals its never-preempted run
    bitwise: tokens, logprobs and the written blocks, scale tiles
    included (block ids differ, content does not)."""
    cfg, params = setup
    qcfg = cfg.with_(kv_dtype=kv_dtype)
    prompt, n_new = [5, 9, 11, 2], 8
    ref, ref_engine = _reference(qcfg, params, prompt, n_new)
    req, engine = _run_with_preemption(qcfg, params, prompt=prompt,
                                       n_new=n_new)
    assert req.output == ref.output
    assert req.logprobs == ref.logprobs
    # the retired requests' blocks still hold their content
    got = tpaged.extract_blocks(engine.caches, _last_blocks(engine, req))
    want = tpaged.extract_blocks(ref_engine.caches,
                                 _last_blocks(ref_engine, ref))
    assert set(got) == set(want)
    if kv_dtype != "bf16":
        assert any("scale" in k for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _last_blocks(engine, req):
    """The blocks a retired request held (recorded at retirement)."""
    return engine.held[req.rid]


@pytest.fixture
def record_blocks(monkeypatch):
    """Engines remember each retiring request's blocks in ``held``."""
    retire = DecodeEngine._retire

    def recording(self, req):
        if not hasattr(self, "held"):
            self.held = {}
        self.held[req.rid] = list(req.blocks)
        retire(self, req)
    monkeypatch.setattr(DecodeEngine, "_retire", recording)


@pytest.mark.parametrize("proposer_kind", ["ngram", "draft"])
def test_preempt_restore_spec_engines(setup, proposer_kind):
    """Both proposers survive preemption: mirror state goes with the slot
    and is rebuilt on restore (the draft model replays prompt +
    output[:-1]), so the continuation stays bitwise."""
    cfg, params = setup

    def make():
        return (NGramProposer() if proposer_kind == "ngram"
                else DraftModelProposer(cfg, params))

    prompt, n_new = [3, 1, 4, 1, 5, 3, 1, 4], 8
    ref, _ = _reference(cfg, params, prompt, n_new, klass=SpecDecodeEngine,
                        proposer=make(), spec_k=2)
    req, _ = _run_with_preemption(cfg, params, SpecDecodeEngine,
                                  prompt=prompt, n_new=n_new,
                                  proposer=make(), spec_k=2)
    assert req.output == ref.output
    assert req.logprobs == ref.logprobs


def test_auto_preempt_lru_under_pool_pressure(setup):
    """preempt='lru': a tight pool swaps the most recently admitted
    request out so the head can admit; every stream is its unperturbed
    run's (at the same max_slots: the decode step's GEMM rows)."""
    cfg, params = setup
    engine = _engine(cfg, params, max_slots=3, num_blocks=7, preempt="lru")
    reqs = [Request(rid=i, prompt=[10 + i, 20 + i], max_new_tokens=6)
            for i in range(4)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    assert all(r.done for r in reqs)
    assert engine.kv_stats["preempted"] >= 1
    for r in reqs:
        ref, _ = _reference(cfg, params, r.prompt, 6, max_slots=3)
        assert r.output == ref.output and r.logprobs == ref.logprobs


def test_priority_policy_picks_lowest_priority_victim(setup):
    cfg, params = setup
    engine = _engine(cfg, params, max_slots=3, num_blocks=6,
                     preempt="priority")
    lo = Request(rid=0, prompt=[1, 2], max_new_tokens=15, priority=0)
    mid = Request(rid=1, prompt=[3, 4], max_new_tokens=15, priority=1)
    hi2 = Request(rid=2, prompt=[5, 6], max_new_tokens=15, priority=2)
    engine.submit(lo)
    engine.submit(mid)
    engine.step()
    engine.submit(hi2)
    engine.step()
    assert lo.state == "preempted" and mid.state != "preempted"
    engine.run_until_done()
    assert all(r.done for r in (lo, mid, hi2))
    for r in (lo, mid, hi2):
        ref, _ = _reference(cfg, params, r.prompt, 15, max_slots=3)
        assert r.output == ref.output and r.logprobs == ref.logprobs


def test_preempt_priority_never_evicts_equal_priority(setup):
    cfg, params = setup
    engine = _engine(cfg, params, max_slots=3, num_blocks=6,
                     preempt="priority")
    reqs = [Request(rid=i, prompt=[1 + 2 * i, 2 + 2 * i],
                    max_new_tokens=15, priority=1) for i in range(3)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    assert all(r.done for r in reqs)
    assert engine.kv_stats["preempted"] == 0


def test_cancel_while_preempted_drops_snapshot(setup):
    cfg, params = setup
    engine = _engine(cfg, params)
    req = Request(rid=0, prompt=[5, 9], max_new_tokens=8)
    engine.submit(req)
    engine.step()
    engine.preempt(0)
    assert engine.swap.holds(0)
    assert engine.request_diagnostics()[0]["state"] == "preempted"
    assert engine.cancel(0)
    assert not engine.swap.holds(0) and len(engine.swap) == 0
    assert engine.swap.stats["dropped_blocks"] >= 1
    assert engine.swap.stats["host_bytes"] == 0
    alloc = engine.scheduler.allocator
    assert alloc.num_free == engine.kv.num_blocks - 1
    with pytest.raises(KeyError):
        engine.preempt(0)


def test_swap_unit_roundtrip(setup):
    """KVSwap alone: snapshot, restore into other block ids, stats, and
    the double swap-out guard."""
    cfg, params = setup
    engine = _engine(cfg.with_(kv_dtype="int8"), params)
    req = Request(rid=0, prompt=[5, 9, 11], max_new_tokens=4)
    engine.submit(req)
    engine.step()
    swap = KVSwap()
    blocks = list(req.blocks)
    want = tpaged.extract_blocks(engine.caches, blocks)
    swap.swap_out(0, engine.caches, blocks)
    assert swap.holds(0) and len(swap) == 1
    assert swap.stats["host_bytes"] == tpaged.snapshot_bytes(want) > 0
    assert swap.stats["host_bytes_total"] == swap.stats["host_bytes"]
    with pytest.raises(AssertionError):
        swap.swap_out(0, engine.caches, blocks)
    alloc = engine.scheduler.allocator
    others = alloc.alloc(len(blocks))
    assert set(others).isdisjoint(blocks)
    with pytest.raises(AssertionError):
        swap.swap_in(0, engine.caches, others + others)   # count differs
    swap.swap_in(0, engine.caches, others)
    got = tpaged.extract_blocks(engine.caches, others)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not swap.holds(0) and swap.stats["host_bytes"] == 0
    assert swap.stats["restored_bytes_total"] == tpaged.snapshot_bytes(want)


def test_swap_miss_raises_symmetrically(setup):
    swap = KVSwap()
    with pytest.raises(SwapMissError):
        swap.swap_in(42, None, [0])
    with pytest.raises(SwapMissError):
        swap.drop(42)
    with pytest.raises(KeyError):
        swap.swap_in(42, None, [0])
    assert issubclass(SwapMissError, ServingError)
    assert swap.stats["dropped_blocks"] == 0
    cfg, params = setup
    engine = _engine(cfg, params)
    req = Request(rid=0, prompt=[5, 9], max_new_tokens=8)
    engine.submit(req)
    engine.step()
    engine.preempt(0)
    assert engine.cancel(0)
    assert len(engine.swap) == 0


def test_restore_vs_reprefill_matches_reference():
    """The H100 forecast is the reference's function evaluated on the
    port's figures (the reference names the compute rate
    ``peak_bf16_flops``; the port's is ``peak_flops``, the bf16 tensor
    cores, see ``ecm.machines``), and it validates its inputs the same
    way."""
    from repro.ecm.tpu import predicted_restore_vs_reprefill as ref_fn
    from repro_torch.ecm.hopper import predicted_restore_vs_reprefill
    from repro_torch.ecm.machines import H100_SXM
    as_ref = dict(H100_SXM, peak_bf16_flops=H100_SXM["peak_flops"])
    for tokens, tb, fpt in ((16, 98304, 2 * 619e6), (4096, 512, 1e9),
                            (16, 1e4, 2e5), (1, 1e6, 1e3)):
        assert predicted_restore_vs_reprefill(tokens, tb, fpt) == \
            ref_fn(tokens, tb, fpt, hw=as_ref)
    # at bf16 tensor-core re-prefill, full-width qwen1.5 (98 304 bf16
    # bytes per token) re-prefills faster than it restores, and so does a
    # reduced test model; a model past ~978 M parameters at those bytes
    # per token restores faster
    assert predicted_restore_vs_reprefill(16, 98304, 2 * 619e6) < 1.0
    assert predicted_restore_vs_reprefill(16, 1e4, 2e5) < 1.0
    assert predicted_restore_vs_reprefill(16, 98304, 2 * 1.2e9) > 1.0
    for bad in (dict(tokens=0, token_bytes=512, flops_per_token=1e9),
                dict(tokens=64, token_bytes=-1, flops_per_token=1e9),
                dict(tokens=64, token_bytes=512, flops_per_token=0)):
        with pytest.raises(ValueError):
            predicted_restore_vs_reprefill(**bad)
