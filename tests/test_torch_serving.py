"""Port serving engine: ``repro_torch.serving.engine.DecodeEngine`` on the
CPU (plain twins) against the reference ``DecodeEngine`` on the same
parameters and requests, plus the engine contracts of
tests/test_serving.py mirrored inside the port.

Cross-framework: greedy token streams are equal and logprobs agree to
the logit deviation of the two stacks (tests/test_torch_model.py
explains its size; fp8 pools are the loosest, since one e4m3 rounding
step is 1/8 of a binade). Inside the port: batched serving emits solo
serving's tokens, with logprobs equal to f32 rounding (torch's CPU GEMM
picks another kernel for one row than for a batch of rows, so the
logits of a slot are not bitwise its solo logits).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import api, common  # noqa: E402
from repro.serving.engine import DecodeEngine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serving.engine import (DecodeEngine, Request,  # noqa: E402
                                        _logit_stats)
from repro_torch.serving.faults import (AdmissionError,  # noqa: E402
                                        FaultInjector, NumericsGuard,
                                        StallError)

MAX_CONTEXT, BLOCK, CHUNK = 64, 16, 32


def _tcfg(**kw):
    return t_reduced(t_get_config("qwen1.5-0.5b")).with_(**kw)


@pytest.fixture(scope="module")
def port():
    cfg = _tcfg()
    return cfg, tapi.init_params(cfg, device="cpu", seed=0)


def _engine(cfg, params, **kw):
    kw.setdefault("max_context", MAX_CONTEXT)
    kw.setdefault("block_size", BLOCK)
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("max_slots", 2)
    return DecodeEngine(cfg, params, device="cpu", **kw)


def _serve(cfg, params, reqs, **kw):
    engine = _engine(cfg, params, **kw)
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    return engine


def _solo(cfg, params, prompt, n):
    r = Request(rid=0, prompt=list(prompt), max_new_tokens=n)
    _serve(cfg, params, [r], max_slots=1)
    return r.output, r.logprobs


# ------------------------------------------------- vs the reference -------

# max |port - reference| logprob over the streams, measured on seed 3:
# bf16 0.025, int8 0.050, fp8 0.50 (one early e4m3 flip in a K row shifts
# a whole logit row of this tiny random model) — held at ~1.5-2x
LOGPROB_ATOL = {"bf16": 0.05, "int8": 0.1, "fp8": 0.75}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_engine_matches_reference_engine(kv_dtype):
    seed = 3
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(
        num_layers=2, kv_dtype=kv_dtype, num_kv_heads=2)
    tcfg = _tcfg(kv_dtype=kv_dtype, num_kv_heads=2)
    params = common.init_params(api.schema(cfg), jax.random.key(seed))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, int(rng.integers(3, 30))).tolist()
               for _ in range(3)]
    ref = [RefRequest(rid=i, prompt=p, max_new_tokens=8)
           for i, p in enumerate(prompts)]
    engine = RefEngine(cfg, params, max_slots=2, max_context=MAX_CONTEXT,
                       block_size=BLOCK, prefill_chunk=CHUNK)
    for r in ref:
        engine.submit(r)
    engine.run_until_done()
    got = [Request(rid=i, prompt=p, max_new_tokens=8)
           for i, p in enumerate(prompts)]
    teng = _serve(tcfg, tparams, got)
    for r, g in zip(ref, got):
        assert g.done and g.output == r.output, (r.rid, r.output, g.output)
        np.testing.assert_allclose(g.logprobs, r.logprobs,
                                   atol=LOGPROB_ATOL[kv_dtype], rtol=0)
    for k in ("paged_bytes", "paged_bytes_bf16", "contiguous_bytes",
              "decode_steps", "prefill_chunks", "prefill_tokens"):
        assert teng.kv_stats[k] == engine.kv_stats[k], k


# ------------------------------------------------- inside the port --------

def test_batched_equals_solo(port):
    cfg, params = port
    specs = [([5, 9, 11], 8), ([1, 2, 3, 4], 8), (list(range(5, 25)), 6)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(specs)]
    _serve(cfg, params, reqs, max_slots=3)
    for r, (p, n) in zip(reqs, specs):
        out, lps = _solo(cfg, params, p, n)
        assert r.output == out
        np.testing.assert_allclose(r.logprobs, lps, rtol=1e-5, atol=1e-5)


def test_mid_stream_join_and_chunk_interleave(port):
    cfg, params = port
    engine = _engine(cfg, params, prefill_chunk=4)
    r1 = Request(rid=1, prompt=[1, 2, 3], max_new_tokens=12)
    engine.submit(r1)
    engine.step()                     # prefilled + first token + 1 decode
    emitted = [len(r1.output)]
    r2 = Request(rid=2, prompt=list(range(5, 25)), max_new_tokens=4)
    engine.submit(r2)                 # 5 chunks of 4, one per step
    for _ in range(5):
        engine.step()
        emitted.append(len(r1.output))
    assert emitted == list(range(2, 8)), emitted
    engine.run_until_done()
    assert r1.output == _solo(cfg, params, r1.prompt, 12)[0]
    assert r2.output == _solo(cfg, params, r2.prompt, 4)[0]


def test_fifo_overload_and_block_reuse(port):
    cfg, params = port
    reqs = [Request(rid=i, prompt=[i + 1, i + 2], max_new_tokens=3)
            for i in range(6)]
    engine = _engine(cfg, params)
    for r in reqs:
        engine.submit(r)
    assert engine.num_unfinished == 6
    order = []
    while engine.num_unfinished:
        engine.step()
        order += [r.rid for r in reqs if r.done and r.rid not in order]
    assert order == list(range(6))
    for r in reqs:
        assert r.output == _solo(cfg, params, r.prompt, 3)[0]
    alloc = engine.scheduler.allocator
    assert alloc.num_free == engine.kv.num_blocks - 1 and alloc.num_held == 0


def test_admission_errors(port):
    cfg, params = port
    engine = _engine(cfg, params)
    with pytest.raises(AdmissionError):
        engine.submit(Request(rid=0, prompt=list(range(60)),
                              max_new_tokens=10))        # 70 > 64
    with pytest.raises(ValueError):                      # back-compat
        engine.submit(Request(rid=0, prompt=list(range(60)),
                              max_new_tokens=10))
    small = _engine(cfg, params, num_blocks=3)           # 32 tokens usable
    with pytest.raises(AdmissionError):
        small.submit(Request(rid=0, prompt=[1] * 30, max_new_tokens=10))
    ok = Request(rid=1, prompt=[1] * 20, max_new_tokens=10)
    small.submit(ok)
    small.run_until_done()
    assert ok.done and len(ok.output) == 10


def test_nan_logits_row_trips_guard(port):
    cfg, params = port
    engine = _engine(cfg, params)
    victim = Request(rid=0, prompt=[5, 9, 11], max_new_tokens=6)
    other = Request(rid=1, prompt=[7, 8], max_new_tokens=6)
    engine.submit(victim)
    engine.submit(other)
    decode = engine._decode
    calls = []

    def poisoned(p, toks, caches):
        logits = decode(p, toks, caches)
        calls.append(1)
        if len(calls) == 2:
            logits[victim.slot] = float("nan")
        return logits

    engine._decode = poisoned
    engine.run_until_done()
    assert victim in engine.quarantined and victim.state == "quarantined"
    assert victim.error.startswith("nonfinite")
    assert engine.kv_stats["guard_trips"] == 1
    assert other.done and other.output == _solo(cfg, params, other.prompt,
                                                6)[0]
    assert engine.scheduler.allocator.num_held == 0


def test_logit_stats_and_guard():
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.standard_normal((3, 300)).astype(np.float32))
    rows[2, 7] = float("nan")
    toks = torch.tensor([4, 5, 6], dtype=torch.int32)
    st = _logit_stats(rows, toks)
    lse = torch.logsumexp(rows[:2].double(), dim=-1)
    np.testing.assert_allclose(st["logsumexp"][:2].numpy(), lse.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(
        st["logprob"][:2].numpy(),
        (rows[[0, 1], [4, 5]].double() - lse).numpy(), rtol=1e-5)
    assert float(st["round_off"][:2].max()) < 1e-5
    host = {k: v.numpy() for k, v in st.items()}
    assert NumericsGuard().check_rows(host) == {2: "nonfinite max"}
    assert NumericsGuard().check_row(host, 2) == "nonfinite max"
    assert NumericsGuard(check_nonfinite=False).check_rows(host) == {
        2: "round_off nan"}


def test_fused_logprobs_match_plain_logsumexp(port):
    cfg, params = port
    r = Request(rid=0, prompt=[5, 9, 11], max_new_tokens=4)
    _serve(cfg, params, [r], max_slots=1)
    kv = tapi.KVCache.build(cfg, max_context=MAX_CONTEXT, block_size=BLOCK,
                            max_slots=1)
    caches = kv.init(1, device="cpu")
    caches["block_table"][:, 0] = torch.arange(1, 5, dtype=torch.int32)
    lg = tapi.prefill_chunk_fn(cfg)(params, torch.tensor([[5, 9, 11]],
                                                         dtype=torch.int32),
                                    caches, 0, 0)
    want = []
    for tok in r.output:
        row = lg[0].double()
        want.append(float(row[tok] - torch.logsumexp(row, 0)))
        lg = tapi.decode_fn(cfg)(params, torch.tensor([[tok]],
                                                      dtype=torch.int32),
                                 caches)
    np.testing.assert_allclose(r.logprobs, want, rtol=1e-5, atol=1e-5)


def test_traffic_accounting_and_stall(port):
    cfg, params = port
    engine = _engine(cfg, params, max_context=256)
    for i in range(3):
        engine.submit(Request(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=4))
    engine.run_until_done()
    st = engine.kv_stats
    assert st["paged_bytes"] > 0
    assert st["contiguous_bytes"] > 4 * st["paged_bytes"]
    q8 = _engine(_tcfg(kv_dtype="int8"), params)
    q8.submit(Request(rid=0, prompt=[5, 9, 11], max_new_tokens=4))
    q8.run_until_done()
    assert q8.kv_stats["paged_bytes_bf16"] > 1.5 * q8.kv_stats["paged_bytes"]
    stuck = _engine(cfg, params)
    stuck.submit(Request(rid=9, prompt=[1, 2], max_new_tokens=20))
    with pytest.raises(StallError) as e:
        stuck.run_until_done(max_steps=3)
    assert e.value.diagnostics[0]["rid"] == 9


def test_later_slices_raise(port):
    cfg, params = port
    # telemetry is the one knob still refused
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(cfg, params, telemetry=object())
    # prefix caching, the spill tier, preemption and priorities are
    # served now; the spill tier needs the prefix cache, as in the
    # reference
    with pytest.raises(ValueError):
        _engine(cfg, params, spill_blocks=4)
    engine = _engine(cfg, params, prefix_cache=True, spill_blocks=4,
                     preempt="lru")
    engine.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=2,
                          priority=10))
    engine.run_until_done()
    # sampling, deadlines and fault injection are served too
    engine = _engine(cfg, params, fault_injector=FaultInjector(0))
    engine.submit(Request(rid=0, prompt=[1], max_new_tokens=2,
                          temperature=1.0, top_k=5, seed=3,
                          deadline_steps=50))
    engine.run_until_done()
    with pytest.raises(NotImplementedError):
        _engine(_tcfg(family="moe"), params)


def test_engine_on_card_matches_cpu(port):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cfg, params = port
    reqs = [Request(rid=i, prompt=[3 + i, 1, 4, 1, 5], max_new_tokens=6)
            for i in range(3)]
    engine = DecodeEngine(cfg, params, max_slots=2, max_context=MAX_CONTEXT,
                          block_size=BLOCK, prefill_chunk=CHUNK,
                          device="cuda")
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    for r in reqs:
        out, lps = _solo(cfg, params, r.prompt, 6)
        assert r.output == out
        np.testing.assert_allclose(r.logprobs, lps, atol=0.05)
