"""Telemetry in the port (``repro_torch.obs``): the tracer, registry and
residual log held to the reference's on the same call sequences (the
JSONL, Chrome and Prometheus exports equal where no wall clock enters),
one engine trace held to the reference engine's on a request stream
whose token streams agree, and the reference's telemetry contracts held
inside the port: the trace is deterministic across reruns and identical
across kv dtypes, spans balance, fault-injection and speculative traces
reproduce, ``metrics_snapshot`` holds every ``kv_stats`` counter, and
telemetry changes no token and no logprob.

Widths are reduced (2 layers) and prompts pinned, so the file stays
small.
"""

import collections
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import obs as robs  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import common as rcommon  # noqa: E402
from repro.serving.engine import DecodeEngine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro_torch import bridge, obs  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.obs.metrics import Histogram  # noqa: E402
from repro_torch.serving import (DecodeEngine, FailoverServer,  # noqa: E402
                                 Request, SpecDecodeEngine, StallError)
from repro_torch.serving.faults import FaultInjector, FaultSpec  # noqa: E402
from repro_torch.spec import DraftModelProposer, NGramProposer  # noqa: E402

MAX_CONTEXT, BLOCK, CHUNK = 64, 16, 32
# a long prompt (two prefill chunks), a short one, and a third that queues
# behind the 2-slot pool; no eos, so the schedule depends on counts only
PROMPTS = [list(range(10, 30)), [3, 1, 4, 1, 5], list(range(40, 47))]
MAX_NEW = 6
SYS = [7, 3, 9, 1, 4, 4, 8, 2, 6, 5, 1, 9, 2, 8, 3, 7,
       5, 5, 2, 9, 6, 1, 7, 3, 8, 8, 4, 2, 9, 5, 6, 1]


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def setup():
    cfg = t_reduced(t_get_config("qwen1.5-0.5b")).with_(num_layers=2)
    return cfg, api.init_params(cfg, device="cpu", seed=0)


def _engine(cfg, params, cls=DecodeEngine, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_context", MAX_CONTEXT)
    kw.setdefault("block_size", BLOCK)
    kw.setdefault("prefill_chunk", CHUNK)
    return cls(cfg, params, device="cpu", **kw)


def _serve(cfg, params, cls=DecodeEngine, **kw):
    engine = _engine(cfg, params, cls,
                     telemetry=kw.pop("telemetry", obs.Telemetry()), **kw)
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=MAX_NEW)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    assert all(r.done for r in reqs)
    return engine, reqs


# ------------------------------------------- units against the reference --

def _trace_calls(t):
    t.begin("queued", rid=2, prompt_tokens=7, max_new=6)
    t.set_step(1)
    t.end("queued", rid=2)
    t.begin("prefill", rid=2, slot=0, blocks=1, prefix_hit=0)
    t.instant("prefill_chunk", rid=2, pos0=0, tokens=7)
    t.instant("decode_step", batch=1)
    t.set_step(2)
    t.instant("fault_injected", step=2, site="logit_nan")
    t.end("prefill", rid=2)
    t.instant("retired", rid=2, emitted=1)


def test_tracer_matches_reference(tmp_path):
    a, b = obs.Tracer(), robs.Tracer()
    _trace_calls(a)
    _trace_calls(b)
    assert a.key_sequence() == b.key_sequence() and len(a) == 8
    assert a.chrome_events() == b.chrome_events()
    assert ([e.key() for e in a.select("queued", rid=2)]
            == [e.key() for e in b.select("queued", rid=2)])
    for name, export in (("t.jsonl", "to_jsonl"), ("t.json", "to_chrome")):
        pa, pb = tmp_path / f"a_{name}", tmp_path / f"b_{name}"
        assert getattr(a, export)(pa) == getattr(b, export)(pb) == 8
        assert pa.read_text() == pb.read_text()
    extra = [{"ph": "C", "name": "ecm/x", "pid": 1, "ts": 0, "args": {}}]
    a.to_chrome(tmp_path / "ca.json", extra_events=extra)
    b.to_chrome(tmp_path / "cb.json", extra_events=extra)
    assert (tmp_path / "ca.json").read_text() == \
        (tmp_path / "cb.json").read_text()
    # the wall clock annotates and never enters the identity
    w = obs.Tracer(wall_clock=True)
    _trace_calls(w)
    assert w.key_sequence() == a.key_sequence()
    assert all(ev.wall is not None for ev in w.events)


def _metric_calls(reg, Hist):
    reg.counter("decode_steps", unit="steps", help="steps").inc(7)
    reg.gauge("prefix_hit_rate").set(0.25)
    h = reg.histogram("ttft_steps", unit="steps", buckets=(1, 2, 4))
    for v in (0.5, 3, 100, 2):
        h.observe(v)
    live = type(reg)()
    live.histogram("queue_wait_steps").observe(3)
    reg.merge(live)
    with pytest.raises(ValueError):
        reg.gauge("decode_steps")
    with pytest.raises(ValueError):
        reg.counter("decode_steps").inc(-1)
    with pytest.raises(ValueError):
        Hist("bad", buckets=(4, 2))
    return [h.quantile(q) for q in (0.0, 0.5, 0.95, 1.0)]


def test_registry_matches_reference():
    a, b = obs.MetricsRegistry(), robs.MetricsRegistry()
    qa = _metric_calls(a, Histogram)
    qb = _metric_calls(b, robs.metrics.Histogram)
    assert qa == qb
    assert a.snapshot() == b.snapshot()
    assert a.to_prometheus() == b.to_prometheus()
    assert "# TYPE repro_ttft_steps histogram" in a.to_prometheus()


def test_residuals_match_reference():
    for mod in (obs, robs):
        with pytest.raises(ValueError):
            mod.ResidualRecord("x", 1.0, 1.0, "vibes")
    a, b = obs.ResidualLog(), robs.ResidualLog()
    for log in (a, b):
        log.record("kahan_overhead/b2f", 1.0, 1.006, basis="wallclock",
                   elems=1 << 24)
        log.record("restore_gate/qwen", 0.6335, 0.0, basis="counter")
    assert a.rows() == b.rows() and len(a) == 2
    assert (obs.residual_row("kv/int8", 1.88, 1.88, basis="counter",
                             dtype="int8")
            == robs.residual_row("kv/int8", 1.88, 1.88, basis="counter",
                                 dtype="int8"))
    assert obs.ResidualRecord("r", 0.0, 1.0, "counter").ratio == float("inf")


# ---------------------------------------- engine against the reference ----

def test_engine_trace_matches_reference_engine():
    """One request stream (prefix hits, copy-on-write, eviction under a
    small pool, preemption to host and restore) through the reference
    engine and the port's, each with telemetry, on the same bridged
    seed-1 weights: the streams agree, and so do the trace key sequences,
    the counters and the step-denominated histograms of the two
    snapshots."""
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(num_layers=2,
                                                     num_kv_heads=2)
    params = rcommon.init_params(rapi.schema(cfg), jax.random.key(1))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    tcfg = t_reduced(t_get_config("qwen1.5-0.5b")).with_(num_layers=2,
                                                          num_kv_heads=2)
    prompts = [SYS + [41, 42], SYS + [11, 12, 13], SYS[:24] + [99, 98],
               [200 + i for i in range(40)], SYS + [41, 42, 5],
               list(SYS), [150 + i for i in range(20)]]
    runs = []
    for engine_cls, req_cls, p, c, tele in (
            (RefEngine, RefRequest, params, cfg, robs.Telemetry()),
            (DecodeEngine, Request, tparams, tcfg, obs.Telemetry())):
        kw = dict(max_slots=3, max_context=MAX_CONTEXT, block_size=BLOCK,
                  prefill_chunk=CHUNK, num_blocks=10, prefix_cache=True,
                  preempt="lru", telemetry=tele)
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
        snap = eng.metrics_snapshot()
        runs.append(([r.output for r in reqs], tele.trace.key_sequence(),
                     {k: v for k, v in snap.items()
                      if k != "round_off_deviation"}))
    assert runs[0][0] == runs[1][0]               # the streams agree
    assert runs[0][1] == runs[1][1]
    names = {k[2] for k in runs[1][1]}
    assert {"prefix_hit", "prefix_evict", "swap_out", "swap_in",
            "preempted", "retired"} <= names
    assert runs[0][2] == runs[1][2]


# ------------------------------------------------ inside the port ---------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_trace_deterministic_and_identical_across_kv_dtypes(setup,
                                                            kv_dtype):
    """Same workload => the same key sequence on a rerun, and (with no
    eos, args carrying counts only) the bf16 run's sequence for every kv
    dtype."""
    cfg, params = setup
    base = _serve(cfg, params)[0].obs.trace.key_sequence()
    c = cfg.with_(kv_dtype=kv_dtype)
    a = _serve(c, params)[0].obs.trace.key_sequence()
    b = _serve(c, params)[0].obs.trace.key_sequence()
    assert a == b == base and len(a) > 0


def test_spans_balanced_and_lifecycle(setup):
    cfg, params = setup
    engine, _ = _serve(cfg, params)
    tr = engine.obs.trace
    opened = collections.Counter(
        (ev.rid, ev.name) for ev in tr.events if ev.ph == "B")
    closed = collections.Counter(
        (ev.rid, ev.name) for ev in tr.events if ev.ph == "E")
    assert opened == closed
    for rid in range(len(PROMPTS)):
        names = [ev.name for ev in tr.events
                 if ev.rid == rid and ev.ph == "B"]
        assert names == ["queued", "prefill", "decode"]
        (ret,) = tr.select("retired", rid=rid)
        assert ret.args["emitted"] == MAX_NEW
    (qb,) = [e for e in tr.select("queued", rid=2) if e.ph == "B"]
    (qe,) = [e for e in tr.select("queued", rid=2) if e.ph == "E"]
    assert qe.step > qb.step


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
def test_spec_trace_deterministic(setup, proposer):
    cfg, params = setup

    def mk():
        p = (NGramProposer() if proposer == "ngram"
             else DraftModelProposer(cfg, params))
        return _serve(cfg, params, SpecDecodeEngine, proposer=p,
                      spec_k=2)[0]

    ea, eb = mk(), mk()
    assert ea.obs.trace.key_sequence() == eb.obs.trace.key_sequence()
    assert len(ea.obs.trace.select("verify_step")) > 0
    snap = ea.metrics_snapshot()
    assert snap["acceptance_rate"] == pytest.approx(ea.acceptance_rate)
    assert snap["mean_accepted_length"] == pytest.approx(
        ea.mean_accepted_length)
    for key, val in ea.kv_stats.items():
        assert snap[key] == val, key


def test_fault_trace_deterministic_with_failover(setup):
    """The same injector seed lands the same faults on the same steps, and
    the whole trace (fault_injected, guard_trip, quarantined,
    failover_retry on the degraded engine sharing the handle)
    reproduces, spans balanced."""
    cfg, params = setup

    def run():
        tele = obs.Telemetry()
        inj = FaultInjector(5, [FaultSpec(site="logit_nan", rate=0.5),
                                FaultSpec(site="alloc_fail", rate=0.3)])
        server = FailoverServer(_engine(cfg, params, fault_injector=inj,
                                        telemetry=tele))
        for i, p in enumerate(PROMPTS):
            server.submit(Request(rid=i, prompt=list(p),
                                  max_new_tokens=MAX_NEW))
        server.run_until_done()
        assert server.degraded is not None
        assert server.degraded.obs is tele
        return tele.trace

    a, b = run(), run()
    assert a.key_sequence() == b.key_sequence()
    for name in ("fault_injected", "guard_trip", "quarantined",
                 "failover_retry"):
        assert a.select(name), name
    opened = collections.Counter((e.rid, e.name) for e in a.events
                                 if e.ph == "B")
    closed = collections.Counter((e.rid, e.name) for e in a.events
                                 if e.ph == "E")
    assert opened == closed


def test_stall_diagnostics_on_trace(setup):
    cfg, params = setup
    engine = _engine(cfg, params, telemetry=obs.Telemetry())
    engine.submit(Request(rid=7, prompt=[1, 2, 3], max_new_tokens=12))
    with pytest.raises(StallError) as e:
        engine.run_until_done(max_steps=2)
    (diag,) = e.value.diagnostics
    (ev,) = engine.obs.trace.select("stall")
    assert ev.rid == diag["rid"] == 7
    assert ev.args == {k: v for k, v in diag.items() if k != "rid"}


def test_metrics_snapshot_holds_kv_stats(setup):
    cfg, params = setup
    engine, _ = _serve(cfg, params)
    snap = engine.metrics_snapshot()
    for key, val in engine.kv_stats.items():
        assert snap[key] == val, key
    for key in ("swap_swapped_out_blocks", "swap_host_bytes",
                "prefix_hit_rate", "round_off_deviation"):
        assert key in snap
    assert snap["ttft_steps"]["count"] == len(PROMPTS)
    assert snap["queue_wait_steps"]["count"] == len(PROMPTS)
    text = engine.metrics_prometheus()
    assert "# TYPE repro_decode_steps counter" in text
    assert f"repro_ttft_steps_count {len(PROMPTS)}" in text
    # without telemetry: the same counters, no histogram series
    bare, _ = _serve(cfg, params, telemetry=None)
    assert bare.obs is obs.NULL and not bare.obs.enabled
    snap = bare.metrics_snapshot()
    for key, val in bare.kv_stats.items():
        assert snap[key] == val, key
    assert "ttft_steps" not in snap


def test_telemetry_changes_no_token_or_logprob(setup):
    """Telemetry with the wall clock (and the sampled path) on vs off:
    tokens and logprobs bitwise."""
    cfg, params = setup
    outs = []
    for tele in (None, obs.Telemetry(wall_clock=True)):
        engine = _engine(cfg, params, telemetry=tele)
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=MAX_NEW,
                        temperature=0.8 * (i % 2), top_k=5, seed=i)
                for i, p in enumerate(PROMPTS)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_done()
        outs.append(([r.output for r in reqs], [r.logprobs for r in reqs]))
        if tele is not None:
            assert engine.metrics_snapshot()["intertoken_seconds"]["count"]
            assert all(ev.wall is not None for ev in tele.trace.events)
    assert outs[0] == outs[1]


def test_chrome_export_tracks(setup, tmp_path):
    cfg, params = setup
    engine, _ = _serve(cfg, params)
    path = tmp_path / "trace.json"
    n = engine.obs.to_chrome(path)
    doc = json.loads(path.read_text())
    assert n == len(engine.obs.trace)
    assert doc["otherData"]["clock"] == "engine-step"
    tids = {e["tid"] for e in doc["traceEvents"] if e["ph"] != "M"}
    assert tids == {0} | {rid + 1 for rid in range(len(PROMPTS))}
