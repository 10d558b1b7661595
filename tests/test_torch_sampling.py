"""Sampled serving in the port: ``_sample_rows`` against the reference's
on identical rows and keys, the port's ``DecodeEngine`` against the
reference engine on bridged weights with sampled requests, and the
sampling contracts of tests/test_serving.py inside the port.

Tolerance: a draw is the argmax of gumbel noise + scaled logits, and the
port's gumbel noise is jax's within 4 f32 epsilons of max(1, |g|)
(tests/test_torch_prng.py). Tokens must be equal, except where the
port's top two perturbed logits lie within ``TIE_EPS`` epsilons of each
other (the noise of both sides may order them either way); on the
pinned rows and prompts below no such near-tie occurs, so every token
is equal.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import api, common  # noqa: E402
from repro.serving.engine import DecodeEngine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import _sample_rows as ref_sample_rows  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serving.engine import (DecodeEngine, Request,  # noqa: E402
                                        _sample_rows)

MAX_CONTEXT, BLOCK, CHUNK = 64, 16, 32
TIE_EPS = 16
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


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


def _near_tie(rows, temps, keys, top_k, i) -> bool:
    """Whether row i's two largest perturbed logits (the port's) lie
    within TIE_EPS epsilons of each other."""
    logits = rows[i].double() / max(float(temps[i]), 1e-6)
    g = prng.gumbel(keys[i], (rows.shape[-1],)).double()
    if top_k:
        kth = torch.topk(logits, top_k).values[-1]
        logits = torch.where(logits < kth, float("-inf"), logits)
    top2 = torch.topk(g + logits, 2).values
    scale = F32_EPS * max(1.0, float(top2[0].abs()))
    return float(top2[0] - top2[1]) <= TIE_EPS * scale


@pytest.mark.parametrize("top_k", [0, 5, 1, 1000])
def test_sample_rows_match_reference(top_k):
    rng = np.random.default_rng(top_k)
    s, v = 8, 300
    rows = (rng.normal(size=(s, v)) * 2).astype(np.float32)
    rows[1, :40] = rows[1].max()               # ties at the top
    rows[2, ::3] = np.sort(rows[2])[-5]        # ties at the k-th value
    temps = np.array([0.5, 1.0, 1.7, 0.0, 1e-7, 2.5, 0.8, 1.0], np.float32)
    seeds = [(i * 7 + 1, i + 3) for i in range(s)]
    jkeys = jnp.stack([jax.random.fold_in(jax.random.key(a), b)
                       for a, b in seeds])
    tkeys = torch.stack([prng.fold_in(prng.key(a, device="cpu"), b)
                         for a, b in seeds])
    want = np.asarray(ref_sample_rows(jnp.asarray(rows), jnp.asarray(temps),
                                      jkeys, top_k))
    got = _sample_rows(torch.from_numpy(rows), torch.from_numpy(temps),
                       tkeys, top_k).numpy()
    for i in range(s):
        if got[i] != want[i]:
            assert _near_tie(torch.from_numpy(rows), temps, tkeys,
                             min(top_k, v), i), (i, got[i], want[i])
    np.testing.assert_array_equal(got, want)      # no near-tie here
    if top_k == 1:
        # row 1's 40 tied maxima are all kept; the others have one
        untied = [i for i in range(s) if i != 1]
        np.testing.assert_array_equal(got[untied],
                                      rows[untied].argmax(axis=1))
        assert rows[1, got[1]] == rows[1].max()


@pytest.mark.parametrize("kv_dtype", ["bf16"])
def test_sampled_engine_matches_reference_engine(kv_dtype):
    """Sampled, top-k and greedy requests side by side, on the
    reference's weights: the same streams and counters. bf16 pools only:
    a draw is equal across the stacks only while the logit deviation
    (tests/test_torch_serving.py: 0.025 on these weights over bf16
    pools, 0.05 over int8) stays below the draw's perturbed top-2 gap,
    which int8's deviation exceeds on these prompts. Inside the port,
    every pool format samples from its own logits with the same keys."""
    seed = 3
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(
        num_layers=2, kv_dtype=kv_dtype, num_kv_heads=2)
    tcfg = _tcfg(kv_dtype=kv_dtype, num_kv_heads=2)
    params = common.init_params(api.schema(cfg), jax.random.key(seed))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, int(rng.integers(3, 30))).tolist()
               for _ in range(4)]
    knobs = [dict(temperature=0.8, top_k=20, seed=11),
             dict(temperature=1.0, top_k=0, seed=12),
             dict(temperature=1.3, top_k=1, seed=13), dict()]

    def run(engine, cls):
        reqs = [cls(rid=i, prompt=p, max_new_tokens=8, **k)
                for i, (p, k) in enumerate(zip(prompts, knobs))]
        for r in reqs:
            engine.submit(r)
        engine.run_until_done()
        return reqs

    ref_eng = RefEngine(cfg, params, max_slots=3, max_context=MAX_CONTEXT,
                        block_size=BLOCK, prefill_chunk=CHUNK)
    ref = run(ref_eng, RefRequest)
    teng = _engine(tcfg, tparams, max_slots=3)
    got = run(teng, Request)
    for r, g in zip(ref, got):
        assert g.done and g.output == r.output, (r.rid, r.output, g.output)
        np.testing.assert_allclose(g.logprobs, r.logprobs, atol=0.1, rtol=0)
    for k in ("decode_steps", "prefill_chunks", "paged_bytes"):
        assert teng.kv_stats[k] == ref_eng.kv_stats[k], k


# ------------------------------------------------- inside the port --------

def test_sampling_deterministic_per_seed(port):
    """Keyed on (request seed, emit index) only: the same seed gives the
    same tokens across engines and batch compositions; other seeds
    diverge (tests/test_serving.py's contract)."""
    cfg, params = port

    def generate(seed, companion=False):
        engine = _engine(cfg, params)
        req = Request(rid=0, prompt=[5, 9, 11], max_new_tokens=8,
                      temperature=1.5, seed=seed)
        engine.submit(req)
        if companion:
            engine.submit(Request(rid=1, prompt=[1, 2], max_new_tokens=8))
        engine.run_until_done()
        return req.output

    solo = generate(7)
    assert generate(7) == solo
    assert generate(7, companion=True) == solo
    assert len({tuple(generate(s)) for s in (7, 8, 9, 10)}) > 1


def _greedy(cfg, params, prompt, n):
    engine = _engine(cfg, params, max_slots=1)
    r = Request(rid=0, prompt=list(prompt), max_new_tokens=n)
    engine.submit(r)
    engine.run_until_done()
    return r


def test_sampling_top_k_one_is_greedy(port):
    cfg, params = port
    engine = _engine(cfg, params)
    req = Request(rid=0, prompt=[5, 9, 11], max_new_tokens=6,
                  temperature=2.0, top_k=1, seed=123)
    engine.submit(req)
    engine.run_until_done()
    assert req.output == _greedy(cfg, params, [5, 9, 11], 6).output
    assert len(req.logprobs) == 6 and all(lp <= 0.0 for lp in req.logprobs)


def test_sampled_slots_keep_greedy_neighbours(port):
    """A decode step with sampled slots beside greedy ones: the greedy
    slots emit their solo greedy streams, and the sampled slots their
    solo sampled streams."""
    cfg, params = port
    prompts = [[5, 9, 11], [1, 2], [7, 7, 7, 3], [40, 2, 9]]
    knobs = [dict(), dict(temperature=0.9, top_k=7, seed=1), dict(),
             dict(temperature=1.4, seed=2)]
    engine = _engine(cfg, params, max_slots=4)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=7, **k)
            for i, (p, k) in enumerate(zip(prompts, knobs))]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    for r, p, k in zip(reqs, prompts, knobs):
        solo_engine = _engine(cfg, params, max_slots=1)
        solo = Request(rid=0, prompt=p, max_new_tokens=7, **k)
        solo_engine.submit(solo)
        solo_engine.run_until_done()
        assert r.output == solo.output, r.rid
        np.testing.assert_allclose(r.logprobs, solo.logprobs, rtol=1e-5,
                                   atol=1e-5)


def test_sample_rows_on_card_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(8, 151936, generator=g) * 3
    temps = torch.full((8,), 0.8)
    keys = torch.stack([prng.fold_in(prng.key(i, device="cpu"), 2)
                        for i in range(8)])
    for top_k in (0, 50, 1):
        cpu = _sample_rows(rows, temps, keys, top_k)
        card = _sample_rows(rows.cuda(), temps.cuda(), keys.cuda(),
                            top_k).cpu()
        for i in range(8):
            if int(cpu[i]) != int(card[i]):
                assert _near_tie(rows, temps, keys, top_k, i)
