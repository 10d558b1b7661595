"""Port parity of the Mamba2 / SSD mixer (``repro_torch.models.ssd``)
against the reference's ``repro.models.ssd`` on the same numpy-seeded
inputs, at a reduced SSMConfig (d_inner 128, 16 states, heads of 32,
chunk 32, d_model 64), the reference's own parameters crossing through
``repro_torch.bridge``.

Tolerances and why:

* the conv and the scan on f32 inputs: both sides compute the same f32
  formulas in another order (XLA fuses and may contract; the port's
  einsums are one scaling and one batched product each), so they agree
  to a few f32 ulps of the values' scale: 1e-5 relative to the largest
  magnitude;
* the mixer (in_proj / out_proj are bf16 products, the scan's output is
  rounded to bf16): an order difference flips a bf16 rounding now and
  then, one bf16 step of 2^-8 relative, carried through the gated norm
  and out_proj: outputs within 2e-2 of the output's largest magnitude,
  and the carried f32 state within 1e-2 of its own;
* inside the port, the chunked scan against the token-by-token
  recurrence (the twin of tests/test_models_layers.py's
  ``test_ssd_chunked_vs_sequential``) at the reference test's 2e-4.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common  # noqa: E402
from repro.models import ssd as S  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import ssd as T  # noqa: E402

CFG = S.SSMConfig(d_inner=128, state_dim=16, head_dim=32, chunk=32)
TCFG = T.SSMConfig(d_inner=128, state_dim=16, head_dim=32, chunk=32)
D_MODEL = 64
SCAN_TOL = 1e-5
MIXER_TOL = 2e-2
STATE_TOL = 1e-2


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a, dtype=None):
    t = bridge.from_numpy(np.asarray(a), device="cpu")
    return t if dtype is None else t.to(dtype)


def _np(t):
    return bridge.to_numpy(t)


def test_config_and_schema_match_the_reference():
    assert tuple(TCFG) == tuple(CFG)
    assert (TCFG.num_heads, TCFG.conv_dim) == (CFG.num_heads, CFG.conv_dim)
    ref = S.mamba2_schema(D_MODEL, CFG)
    port = T.mamba2_schema(D_MODEL, TCFG)
    assert set(ref) == set(port)
    for k, spec in ref.items():
        assert port[k].shape == spec.shape and port[k].init == spec.init, k
    spec = T.mamba2_cache_spec(3, TCFG)
    for k, s in S.mamba2_cache_spec(3, CFG).items():
        assert spec[k][0] == s.shape, k
        assert spec[k][1].itemsize == np.dtype(s.dtype).itemsize, k


@pytest.mark.parametrize("history", [False, True])
def test_causal_conv1d(history):
    rng = np.random.default_rng(0)
    c = CFG.conv_dim
    x = rng.standard_normal((2, 37, c)).astype(np.float32)
    w = (rng.standard_normal((4, c)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    hist = rng.standard_normal((2, 3, c)).astype(np.float32)
    want = S.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           jnp.asarray(hist) if history else None)
    got = T.causal_conv1d(_t(x), _t(w), _t(b), _t(hist) if history else None)
    assert _rel(_np(got), want) <= SCAN_TOL
    # bf16 activations, as the mixer feeds them: at most one bf16 step
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = S.causal_conv1d(xb, jnp.asarray(w), jnp.asarray(b))
    got = T.causal_conv1d(_t(np.asarray(xb)), _t(w), _t(b))
    assert got.dtype == torch.bfloat16
    assert _rel(_np(got), np.asarray(want, np.float32)) <= 2 ** -8


CONV_LAYOUT = """
import json, os, sys, numpy as np, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from repro_torch.distributed import sharding
from repro_torch.ecm import step_cost
from repro_torch.models import ssd
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
inp = np.load(sys.argv[1])
x = torch.from_numpy(inp["x"]).to(torch.bfloat16)
w, b = torch.from_numpy(inp["w"]), torch.from_numpy(inp["b"])
want = ssd.causal_conv1d(x, w, b)
n = x.shape[0] // 4                      # rank 0's rows of the batch
xd = DTensor.from_local(x[:n], mesh, [Shard(0)], run_check=False,
                        shape=x.shape, stride=x.stride())
with sharding.activation_sharding(mesh), \\
        step_cost.StepCounter(record=True) as counter:
    got = ssd.causal_conv1d(xd, w, b)
counter.finish()
print(json.dumps({
    "batch_split": [p.is_shard() and p.dim == 0 for p in got.placements],
    "shape": list(got.shape),
    "bitwise": bool(torch.equal(got.to_local(), want[:n])),
    "local_rows": sorted({t[1][0] for t in counter.cost.peak_tensors
                          if len(t[1]) == 3})}))
"""


def test_causal_conv1d_keeps_a_batch_layout(tmp_path):
    """``causal_conv1d`` on a DTensor split over the batch (a fake group
    of 4 ranks, in a subprocess of its own): the output is laid out the
    same way, rank 0's rows are bitwise the plain call's, and no buffer
    the call makes carries the global batch (8): each holds rank 0's 2
    rows. Its accumulator once came from the DTensor's global shape, a
    plain [8, L, C] f32 tensor on every rank."""
    import json
    import os
    import subprocess
    import sys
    rng = np.random.default_rng(4)
    c = CFG.conv_dim
    np.savez(tmp_path / "in.npz",
             x=rng.standard_normal((8, 37, c)).astype(np.float32),
             w=(rng.standard_normal((4, c)) * 0.5).astype(np.float32),
             b=(rng.standard_normal(c) * 0.1).astype(np.float32))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", CONV_LAYOUT, str(tmp_path / "in.npz")],
        capture_output=True, text=True, timeout=120, cwd=repo,
        env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
                 OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["batch_split"] == [True]
    assert got["shape"] == [8, 37, c]
    assert got["bitwise"]
    assert got["local_rows"] == [2]


def _scan_inputs(seed=0, b=2, l=70, h=4, p=32, n=16, a_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, l, h))).astype(np.float32) * 0.5
    a = -np.abs(rng.standard_normal(h)).astype(np.float32) * a_scale
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return x, dt, (dt * a).astype(np.float32), bm, cm, s0


@pytest.mark.parametrize("kahan_state", [False, True])
@pytest.mark.parametrize("initial", [False, True])
def test_chunk_scan_matches_reference(kahan_state, initial):
    x, dt, al, bm, cm, s0 = _scan_inputs()
    y, st = S._ssd_chunk_scan(*(jnp.asarray(v) for v in (x, dt, al, bm, cm)),
                              32, kahan_state,
                              initial_state=jnp.asarray(s0) if initial
                              else None)
    ty, tst = T._ssd_chunk_scan(*(_t(v) for v in (x, dt, al, bm, cm)), 32,
                                kahan_state,
                                initial_state=_t(s0) if initial else None)
    assert ty.shape == tuple(y.shape) and tst.shape == tuple(st.shape)
    assert _rel(_np(ty), y) <= SCAN_TOL
    assert _rel(_np(tst), st) <= SCAN_TOL


def _ssd_sequential(x, dt, a, bmat, cmat):
    """Token-by-token recurrence in f64: S_t = exp(dt_t A) S_{t-1} +
    dt_t B_t x_t; y_t = C_t . S_t."""
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    s = np.zeros((b, h, n, p))
    ys = []
    for t in range(l):
        decay = np.exp(dt[:, t] * a)[:, :, None, None]
        outer = np.einsum("bn,bhp,bh->bhnp", bmat[:, t], x[:, t], dt[:, t])
        s = s * decay + outer
        ys.append(np.einsum("bn,bhnp->bhp", cmat[:, t], s))
    return np.stack(ys, axis=1), s


@pytest.mark.parametrize("l,chunk", [(64, 16), (100, 32), (16, 16)])
def test_chunked_vs_sequential(l, chunk):
    rng = np.random.default_rng(0)
    b, h, p, n = 2, 3, 8, 4
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, l, h))).astype(np.float32) * 0.5
    a = -np.abs(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    y, state = T._ssd_chunk_scan(_t(x), _t(dt), _t(dt * a), _t(bm), _t(cm),
                                 chunk, False)
    y_ref, s_ref = _ssd_sequential(x, dt, a, bm, cm)
    np.testing.assert_allclose(_np(y), y_ref, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(state), s_ref, atol=2e-4, rtol=2e-4)


def test_kahan_state_matches():
    """A long, slowly decaying carry (the structure the paper's technique
    targets): the compensated state is within the reference test's 5e-4
    of the f64 recurrence (the twin of tests/test_models_layers.py's
    ``test_ssd_kahan_state_matches``)."""
    rng = np.random.default_rng(1)
    b, l, h, p, n, chunk = 1, 128, 2, 4, 4, 16
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, l, h))).astype(np.float32)
    a = -np.abs(rng.standard_normal(h)).astype(np.float32) * 0.01
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    _, s_comp = T._ssd_chunk_scan(_t(x), _t(dt), _t(dt * a), _t(bm), _t(cm),
                                  chunk, True)
    _, s_ref = _ssd_sequential(x, dt, a, bm, cm)
    assert np.max(np.abs(_np(s_comp) - s_ref)) < 5e-4


_PARAMS = {}


def _params():
    if not _PARAMS:
        p = common.init_params(S.mamba2_schema(D_MODEL, CFG),
                               jax.random.key(3))
        # non-trivial decay, skip and bias leaves (the schema inits them
        # to constants)
        rng = np.random.default_rng(4)
        h = CFG.num_heads
        p["A_log"] = jnp.asarray(rng.standard_normal(h).astype(np.float32))
        p["dt_bias"] = jnp.asarray(
            rng.standard_normal(h).astype(np.float32) * 0.5)
        p["D"] = jnp.asarray(rng.standard_normal(h).astype(np.float32))
        p["conv_b"] = jnp.asarray(
            rng.standard_normal(CFG.conv_dim).astype(np.float32) * 0.1)
        _PARAMS["ref"] = p
        _PARAMS["port"] = bridge.params_from_reference(
            jax.tree.map(np.asarray, p), device="cpu")
    return _PARAMS["ref"], _PARAMS["port"]


def _hidden(seed, b, l):
    h = np.random.default_rng(seed).standard_normal((b, l, D_MODEL))
    hb = jnp.asarray(h.astype(np.float32)).astype(jnp.bfloat16)
    return hb, _t(np.asarray(hb))


@pytest.mark.parametrize("kahan_state", [False, True])
def test_mamba2_forward(kahan_state):
    ref, port = _params()
    hb, th = _hidden(5, 2, 45)
    cfg, tcfg = (CFG._replace(kahan_state=kahan_state),
                 TCFG._replace(kahan_state=kahan_state))
    out, cache = S.mamba2_forward(ref, hb, cfg, return_state=True)
    tout, tcache = T.mamba2_forward(port, th, tcfg, return_state=True)
    assert tout.dtype == torch.bfloat16 and tout.shape == tuple(out.shape)
    assert _rel(_np(tout), np.asarray(out, np.float32)) <= MIXER_TOL
    assert _rel(_np(tcache["ssm"]), cache["ssm"]) <= STATE_TOL
    assert _rel(_np(tcache["conv"]),
                np.asarray(cache["conv"], np.float32)) <= MIXER_TOL
    assert torch.equal(T.mamba2_forward(port, th, tcfg), tout)


def _cache_pair(l0=40):
    """A decode cache after ``l0`` prompt tokens, from the reference (and
    the same bits for the port)."""
    ref, port = _params()
    hb, _ = _hidden(6, 2, l0)
    _, cache = S.mamba2_forward(ref, hb, CFG, return_state=True)
    cache = {"ssm": cache["ssm"], "conv": cache["conv"].astype(jnp.bfloat16)}
    tcache = {k: _t(np.asarray(v)) for k, v in cache.items()}
    return cache, tcache


@pytest.mark.parametrize("kahan_state", [False, True])
def test_mamba2_prefill_chunk_continues(kahan_state):
    ref, port = _params()
    cache, tcache = _cache_pair()
    hb, th = _hidden(7, 2, 29)
    cfg, tcfg = (CFG._replace(kahan_state=kahan_state),
                 TCFG._replace(kahan_state=kahan_state))
    out, new = S.mamba2_prefill_chunk(ref, hb, cfg, cache)
    tout, tnew = T.mamba2_prefill_chunk(port, th, tcfg, tcache)
    assert _rel(_np(tout), np.asarray(out, np.float32)) <= MIXER_TOL
    assert _rel(_np(tnew["ssm"]), new["ssm"]) <= STATE_TOL
    assert tnew["conv"].dtype == torch.bfloat16
    assert _rel(_np(tnew["conv"]),
                np.asarray(new["conv"], np.float32)) <= MIXER_TOL
    # with a zero cache the chunk is the full-sequence forward bitwise
    zero = {k: torch.zeros_like(v) for k, v in tcache.items()}
    a, za = T.mamba2_prefill_chunk(port, th, tcfg, zero)
    b, zb = T.mamba2_forward(port, th, tcfg, return_state=True)
    assert torch.equal(a, b) and torch.equal(za["ssm"], zb["ssm"])
    assert torch.equal(za["conv"], zb["conv"])


def test_mamba2_decode_in_place():
    ref, port = _params()
    cache, tcache = _cache_pair()
    hb, th = _hidden(8, 2, 1)
    out, new = S.mamba2_decode(ref, hb, CFG, cache)
    tout = T.mamba2_decode(port, th, TCFG, tcache)      # tcache in place
    assert _rel(_np(tout), np.asarray(out, np.float32)) <= MIXER_TOL
    assert _rel(_np(tcache["ssm"]), new["ssm"]) <= STATE_TOL
    assert _rel(_np(tcache["conv"]),
                np.asarray(new["conv"], np.float32)) <= MIXER_TOL


def test_decode_steps_equal_one_prefill():
    """Inside the port: a prompt decoded token by token leaves the state
    a one-chunk prefill leaves, to f32 rounding of the two formulations."""
    _, port = _params()
    _, th = _hidden(9, 1, 12)
    zero = {k: torch.zeros(s, dtype=dt) for k, (s, dt)
            in T.mamba2_cache_spec(1, TCFG).items()}
    step = {k: v.clone() for k, v in zero.items()}
    outs = [T.mamba2_decode(port, th[:, t:t + 1], TCFG, step)
            for t in range(12)]
    full, new = T.mamba2_prefill_chunk(port, th, TCFG, zero)
    assert _rel(_np(step["ssm"]), _np(new["ssm"])) <= STATE_TOL
    assert torch.equal(step["conv"], new["conv"])
    assert _rel(_np(torch.cat(outs, 1)), _np(full)) <= MIXER_TOL


def test_lm_forward_of_a_mamba2_stack():
    """The training forward of reduced mamba2-780m (2 Mamba2 layers):
    logits [B, L, V] bf16 against the reference's ``lm_forward``, compiled
    with ``xla_allow_excess_precision`` off as tests/test_torch_train.py
    does, within ``MIXER_TOL`` of the largest logit."""
    from repro.configs import get_config, reduced
    from repro.models import api, lm
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.configs import reduced as t_reduced
    from repro_torch.models import lm as tlm

    cfg = reduced(get_config("mamba2-780m"))
    tcfg = t_reduced(t_get_config("mamba2-780m"))
    params = common.init_params(api.schema(cfg), jax.random.key(5))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    tokens = np.random.default_rng(6).integers(0, 256, (2, 40)).astype(
        np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    fwd = jax.jit(lambda p, b: lm.lm_forward(p, b, cfg)).lower(
        params, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})
    want, _ = fwd(params, batch)
    got, aux = tlm.lm_forward(tparams, {"tokens": torch.from_numpy(tokens)},
                              tcfg)
    assert got.shape == tuple(want.shape) and got.dtype == torch.bfloat16
    assert _rel(_np(got), np.asarray(want, np.float32)) <= MIXER_TOL
    assert all(float(v) == 0.0 for v in aux.values())
