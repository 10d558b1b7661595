"""Fault tolerance in the port: ``FaultInjector`` decisions bitwise against
the reference's over a (seed, site, step) grid, ``paged.poison_blocks``
against the reference's on bridged pools, a fault-injected run against
the reference engine, and the cases of tests/test_faults.py that need no
swap tier or prefix cache, mirrored inside the port (the sweep of
tests/test_faults.py:565 runs without preemption and prefix caching,
which are not ported yet).

The injector is a host rule over keyed scalar draws, so its decisions
are equal bit for bit. Engine outputs inside the port are compared with
a fresh unperturbed port engine, as the reference's tests do.
"""

import pytest

torch = pytest.importorskip("torch")

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
                                 FaultSpec, Request, ServingError,
                                 SpecDecodeEngine, StallError,
                                 degraded_engine)
from repro_torch.spec import NGramProposer  # noqa: E402

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
                     num_blocks=9, fault_injector=inj)
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
    assert engine.scheduler.allocator.num_held == 0
