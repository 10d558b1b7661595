"""The port's ECM attribution profiler (``repro_torch.obs.profile``) on a
reduced engine on the CPU: ``Telemetry(profile=True)`` gating, counters
deterministic across two runs, counter tracks merged into the Chrome
export only, ``calibrate()`` positive on the plain twin, the cost model
by hand, and profiling changing no token.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.ecm import hopper  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.obs import profile  # noqa: E402
from repro_torch.serving import DecodeEngine, Request  # noqa: E402

PROMPTS = [list(range(10, 30)), [3, 1, 4, 1, 5], list(range(40, 47))]


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(num_layers=2)
    return cfg, api.init_params(cfg, device="cpu", seed=0)


def _serve(cfg, params, tele, preempt: bool = False):
    engine = DecodeEngine(cfg, params, max_slots=2, max_context=64,
                          block_size=16, prefill_chunk=32, device="cpu",
                          telemetry=tele,
                          num_blocks=4 if preempt else None,
                          preempt="lru" if preempt else "off")
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=6 + 10 * preempt)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    return engine, [(r.output, r.logprobs) for r in reqs]


def test_profile_gating(setup):
    assert obs.Telemetry().profile is None
    assert obs.NULL.profile is None
    tele = obs.Telemetry(profile=True)
    assert isinstance(tele.profile, profile.Profiler)
    cfg, params = setup
    plain = DecodeEngine(cfg, params, device="cpu")
    assert plain._costs is None
    assert DecodeEngine(cfg, params, device="cpu",
                        telemetry=tele)._costs is not None


def test_counters_deterministic_and_tokens_unchanged(setup):
    """Two profiled runs: identical counter tables (launches counted once
    per launch signature, costs from shapes); the streams bitwise those
    of an engine without telemetry. Preemption adds swap phases."""
    cfg, params = setup
    tables, streams = [], []
    for tele in (obs.Telemetry(profile=True), obs.Telemetry(profile=True),
                 None):
        engine, out = _serve(cfg, params, tele, preempt=True)
        streams.append(out)
        if tele is not None:
            tables.append(tele.profile.counter_table())
    assert tables[0] == tables[1]
    assert streams[0] == streams[1] == streams[2]
    phases = {row[0] for row in tables[0]}
    assert {"prefill_chunk", "decode_step", "ops.logit_stats", "swap_out",
            "swap_in"} <= phases
    calls = {row[0]: row[1] for row in tables[0]}
    assert all(n > 0 for n in calls.values())


def test_reset_keeps_caches_and_attribution_renders(setup):
    cfg, params = setup
    tele = obs.Telemetry(profile=True)
    engine, _ = _serve(cfg, params, tele)
    prof = tele.profile
    first = prof.counter_table()
    prof.reset()
    assert prof.phases == {} and prof._launch_cache
    _serve(cfg, params, tele)          # a second engine, same shapes
    assert prof.counter_table() == first
    prof.calibrate(reps=2, elems=1 << 12, device="cpu")
    text = prof.render()
    assert "decode_step" in text and "calibration" in text
    doc = prof.to_json()
    assert [p["phase"] for p in doc["phases"]] == list(prof.phases)
    for a in prof.attribution():
        assert a.wall_s > 0 and a.calls > 0


def test_counter_events_merge_only_at_export(setup, tmp_path):
    cfg, params = setup
    tele = obs.Telemetry(profile=True)
    _serve(cfg, params, tele)
    assert all(ev.ph in ("B", "E", "i") for ev in tele.trace.events)
    path = tmp_path / "trace.json"
    assert tele.to_chrome(path) == len(tele.trace)
    evs = json.loads(path.read_text())["traceEvents"]
    counters = [e for e in evs if e["ph"] == "C"]
    assert len(counters) == len(tele.profile.counter_events()) > 0
    assert {e["name"] for e in counters} >= {"ecm/decode_step",
                                             "ecm/prefill_chunk"}
    plain = obs.Telemetry()
    _serve(cfg, params, plain)
    assert plain.trace.key_sequence() == tele.trace.key_sequence()


def test_calibrate_positive_on_the_plain_twin():
    cal = profile.calibrate(reps=2, elems=1 << 12, device="cpu")
    assert cal.ref_s > 0 and cal.dispatch_s > 0
    assert cal.machine_scale > 0 and cal.host_drift_factor > 0
    assert cal.elems == 1 << 12
    assert set(cal.to_json()) == {"ref_s", "dispatch_s",
                                  "host_drift_factor", "machine_scale",
                                  "elems"}


def test_cost_model_by_hand(setup):
    """Decode step of qwen-shaped reduced weights: the bf16 products are
    2 x tokens x the bf16 weights' elements; the f32 LM head counts per
    logit row on the CUDA cores; bytes hold every weight once."""
    cfg, params = setup
    cm = profile.CostModel(cfg, params, token_bytes=1000)
    layers = params["layers"]
    dot = sum(p.numel() for lp in layers for k, p in lp["attn"].items()
              if k in ("wq", "wk", "wv", "wo"))
    dot += sum(p.numel() for lp in layers for p in lp["ffn"].values())
    assert cm.dot_per_token == dot
    c = cm.decode_step(rows=8, context=160)
    assert c.dot_flops == 2 * 8 * dot
    head = cfg.d_model * cfg.vocab_size
    attn = cfg.num_layers * 160 * (4 * cfg.num_heads * cfg.head_dim
                                   + 5 * cfg.num_heads)
    assert c.flops - c.dot_flops >= 2 * 8 * head + attn
    wbytes = sum(t.numel() * t.element_size()
                 for path, t in profile._leaves(params)
                 if path[-1] != "embed")
    assert c.hbm_bytes >= wbytes + (160 + 8) * 1000
    assert profile.CostModel.copy(512).hbm_bytes == 1024
    # calibration's model time: the compensated dot at the HBM rate
    assert hopper.predicted_runtime_s(hopper.KAHAN_DOT, 1 << 24) == \
        pytest.approx(8 * 2 ** 24 / 3.35e12)


def test_launch_counter_counts_ops_not_views():
    x = torch.ones(4, 4)
    with profile.LaunchCounter("cpu") as c:
        y = (x @ x).t()                   # mm, then a view
        y = y.reshape(-1)                 # a copy of the transposed view
        torch.empty(3)
    assert c.count == 2
    with profile.LaunchCounter("cuda") as c:
        x + 1                             # nothing on the card
    assert c.count == 0
