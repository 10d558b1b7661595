"""Port parity of the optimizer layer: ``optim.adamw`` (naive, Kahan
carry, f32 master weights), ``optim.accumulate`` (the Kahan microbatch
accumulator, fused gradient statistics) and the schedule, against
``repro.optim`` on identical inputs.

Tolerances: the Kahan accumulator is adds only, so it is held BITWISE
to the reference's ``KahanState.add`` chain (the port's runs B7's plain
twin on the CPU). AdamW's update is elementwise f32 in the reference's
order, but the compiled reference does not give every element the
port's bits (``b ** count`` is a library ``pow``, and a single step on
this file's trees already leaves one element 1 ulp apart), so new
parameters, moments and masters are held to 4 ulp (2^-21 relative). The
carry is held through what it carries: base + carry, summed in f64,
within 1/8 ulp of the base, element by element (measured at most 0.047
ulp; a carry of zeros misses by up to 1.75 ulp, as the carry grows past
one ulp over the three steps). ``gradient_stats`` streams each leaf through the
reduction engine, the reference in Pallas interpret mode, the port
through the plain twin: held at the compensated bound of the B2f parity
tests (4 ulp of the value plus 16 eps^2 sum|g^2|), max|g| equal.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kahan as rk  # noqa: E402
from repro.optim import accumulate as racc  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro_torch.core import kahan as tk  # noqa: E402
from repro_torch.optim import accumulate as tacc  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

ULP4 = 2.0 ** -21
CARRY_ULP = 0.125


def _tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((16, 8)) * scale).astype(np.float32),
            "layers": [{"b": (rng.standard_normal(8) * scale)
                        .astype(np.float32)} for _ in range(2)]}


def _ref(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(dtype)
                        if dtype else torch.from_numpy(a.copy()), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got_tree, want_tree, rtol=ULP4):
    got = tk.tree_leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=1e-30)


@pytest.mark.parametrize("kahan,master", [(False, False), (True, False),
                                          (True, True), (False, True)])
def test_adamw_update_matches_reference(kahan, master):
    """Three updates on identical gradients, with a warmup-cosine lr."""
    cfg_kw = dict(lr=1e-2, kahan=kahan, master_weights=master)
    rcfg, tcfg = radamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    p0 = _tree(0)
    dtype = torch.bfloat16 if master else None
    rp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), _ref(p0)) \
        if master else _ref(p0)
    tp = _port(p0, dtype)
    rs, ts = radamw.init(rp, rcfg), tadamw.init(tp, tcfg)
    for step in range(3):
        g = _tree(10 + step)
        lr_r = radamw.warmup_cosine(jnp.asarray(step + 2), warmup=2,
                                    total=10)
        lr_t = tadamw.warmup_cosine(torch.tensor(step + 2), warmup=2,
                                    total=10)
        rp, rs = radamw.update(_ref(g), rs, rp, rcfg, lr_r)
        tp, ts = tadamw.update(_port(g), ts, tp, tcfg, lr_t)
    assert int(ts.count) == int(rs.count) == 3
    _close(tp, rp)
    _close(ts.m, rs.m)
    _close(ts.v, rs.v)
    assert (ts.carry is None) == (rs.carry is None)
    assert (ts.master is None) == (rs.master is None)
    if kahan:
        # the carry holds what the base could not: base + carry within
        # CARRY_ULP of one ulp of each base element
        for c, w, b, rb in zip(tk.tree_leaves(ts.carry),
                               jax.tree.leaves(rs.carry),
                               tk.tree_leaves(ts.master if master else tp),
                               jax.tree.leaves(rs.master if master else rp)):
            rb = _np(rb)
            got = _np(b).astype(np.float64) + _np(c)
            want = rb.astype(np.float64) + _np(w)
            ulp = np.spacing(np.abs(rb)).astype(np.float64)
            assert (np.abs(got - want) <= CARRY_ULP * ulp).all(), \
                np.abs(got - want).max()
    if master:
        _close(ts.master, rs.master)
        assert all(t.dtype == torch.bfloat16 for t in tk.tree_leaves(tp))


def test_kahan_adamw_preserves_tiny_updates():
    """Updates of ~eps·|param| are dropped by naive p += delta but kept by
    the compensated variant: the paper's accumulation failure mode."""
    base, delta, n_steps = 1.0, 3e-8, 4000
    p_naive = torch.tensor(base, dtype=torch.float32)
    p_comp = torch.tensor(base, dtype=torch.float32)
    carry = torch.tensor(0.0, dtype=torch.float32)
    d = torch.tensor(delta, dtype=torch.float32)
    for _ in range(n_steps):
        p_naive = p_naive + d
        p_comp, carry = tk.neumaier_step(p_comp, carry, d)
    exact = base + n_steps * delta
    assert abs(float(p_naive) - base) == 0.0          # every update lost
    assert abs(float(p_comp + carry) - exact) < 1e-7  # all preserved


def test_kahan_state_in_adamw_update_path():
    """lr 1e-9 on params of 100: a naive update freezes them, the carry
    holds the updates (the reference's test, through the port's update,
    whose carry step is B7's twin here)."""
    cfg = tadamw.AdamWConfig(lr=1e-9, weight_decay=0.0, kahan=True)
    params = {"w": torch.full((16,), 100.0)}
    state = tadamw.init(params, cfg)
    g = {"w": torch.ones(16)}
    for _ in range(100):
        params, state = tadamw.update(g, state, params, cfg)
    assert (params["w"] == 100.0).all()
    effective = params["w"].double() + state.carry["w"].double()
    assert (effective < 100.0).all()
    np.testing.assert_allclose((100.0 - effective).numpy(), 100 * 1e-9,
                               rtol=0.3)


def test_adamw_converges_quadratic():
    cfg = tadamw.AdamWConfig(lr=0.05, weight_decay=0.0)
    params = {"w": torch.tensor([2.0, -3.0, 0.5])}
    state = tadamw.init(params, cfg)
    for _ in range(200):
        params, state = tadamw.update({"w": 2 * params["w"]}, state,
                                      params, cfg)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3


def test_kahan_accumulator_bitwise_reference():
    """Microbatch gradients of a fixed list (the loss is linear in the
    parameter, so each microbatch's gradient IS its row): the port's
    accumulator (one B7 step per leaf per microbatch) against the
    reference's ``accumulate_gradients`` and a bare ``KahanState.add``
    chain, bitwise; the naive form too."""
    rng = np.random.default_rng(7)
    n_micro = 16
    big = (rng.standard_normal((n_micro, 33)) * 3e4).astype(np.float32)
    rows = big + (rng.standard_normal((n_micro, 33)) * 1e-3).astype(
        np.float32)

    def r_loss(p, b):
        return jnp.sum(p["w"] * b["g"][0]), {"m": jnp.sum(b["g"])}

    def t_loss(p, b):
        return torch.sum(p["w"] * b["g"][0]), {"m": torch.sum(b["g"])}

    micro = rows[:, None]
    chain = rk.KahanState({"w": jnp.zeros(33)}, {"w": jnp.zeros(33)})
    for r in rows:
        chain = chain.add({"w": jnp.asarray(r)})
    for kahan in (True, False):
        rl, rg, rm = racc.accumulate_gradients(
            r_loss, {"w": jnp.zeros(33)}, {"g": jnp.asarray(micro)},
            kahan=kahan)
        tl, tg, tm = tacc.accumulate_gradients(
            t_loss, {"w": torch.zeros(33)}, {"g": torch.from_numpy(micro)},
            kahan=kahan)
        np.testing.assert_array_equal(_np(tg["w"]).view(np.uint32),
                                      _np(rg["w"]).view(np.uint32))
        np.testing.assert_allclose(float(tl), float(rl), rtol=1e-6)
        np.testing.assert_allclose(float(tm["m"]), float(rm["m"]),
                                   rtol=1e-6)
    np.testing.assert_array_equal(
        (_np(chain.value()["w"]) / n_micro).view(np.uint32),
        _np(tacc.accumulate_gradients(
            t_loss, {"w": torch.zeros(33)},
            {"g": torch.from_numpy(micro)})[1]["w"]).view(np.uint32))


def test_kahan_grad_accumulation_long_chain():
    """Cancelling pairs + a small signal: the compensated accumulator
    keeps the signal within the Kahan bound; naive loses bits."""
    n_micro = 512
    rng = np.random.default_rng(5)
    big = (rng.standard_normal(n_micro // 2) * 3e5).astype(np.float32)
    gs = np.empty(n_micro, np.float32)
    gs[0::2], gs[1::2] = big, -big
    gs += rng.standard_normal(n_micro).astype(np.float32) * 1e-3

    def loss(p, b):
        return p["w"] * b["g"][0], {}

    micro = {"g": torch.from_numpy(gs)[:, None]}
    w = {"w": torch.tensor(0.0)}
    _, g_comp, _ = tacc.accumulate_gradients(loss, w, micro, kahan=True)
    _, g_naive, _ = tacc.accumulate_gradients(loss, w, micro, kahan=False)
    exact = math.fsum(np.float64(gs).tolist()) / n_micro
    err_c = abs(float(g_comp["w"]) - exact)
    err_n = abs(float(g_naive["w"]) - exact)
    eps = np.finfo(np.float32).eps
    assert err_c <= 8 * eps * np.abs(gs).sum() / n_micro + 1e-12
    assert err_c <= err_n + 1e-12


def _compensated(want, got, terms):
    eps = 2.0 ** -24
    tol = 4 * eps * abs(float(want)) + 16 * eps ** 2 * float(np.sum(terms))
    assert abs(float(got) - float(want)) <= tol, (got, want, tol)


def test_gradient_stats_match_reference():
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((257, 33)).astype(np.float32),
            "b": [(rng.standard_normal(1000) * 100).astype(np.float32),
                  rng.standard_normal(8).astype(np.float32)]}
    want = racc.gradient_stats(_ref(tree), interpret=True)
    got = tacc.gradient_stats(_port(tree))
    sq = np.concatenate([np.float64(x).ravel() ** 2
                         for x in jax.tree.leaves(tree)])
    _compensated(float(want["global_norm"]) ** 2,
                 float(got["global_norm"]) ** 2, sq)
    assert float(got["max_abs"]) == float(want["max_abs"])
    np.testing.assert_allclose(float(got["global_norm"]),
                               math.sqrt(math.fsum(sq)), rtol=1e-6)
    # the fused and plain clip paths agree
    cf, nf = tadamw.clip_by_global_norm(_port(tree), 1.0, fused=True)
    cp, n_p = tadamw.clip_by_global_norm(_port(tree), 1.0)
    np.testing.assert_allclose(float(nf), float(n_p), rtol=1e-6)
    for a, b in zip(tk.tree_leaves(cf), tk.tree_leaves(cp)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-7)


def test_clip_by_global_norm_matches_reference():
    g = _tree(3, 10.0)
    rc, rn = radamw.clip_by_global_norm(_ref(g), 1.0)
    tc, tn = tadamw.clip_by_global_norm(_port(g), 1.0)
    np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
    _close(tc, rc, rtol=2e-6)
    assert float(tadamw.global_norm(tc)) == pytest.approx(1.0, rel=1e-5)
    small = _tree(3, 1e-3)                     # under max_norm: unchanged
    tc, _ = tadamw.clip_by_global_norm(_port(small), 1.0)
    _close(tc, _ref(small), rtol=0)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 100, 150])
def test_warmup_cosine_matches_reference(step):
    want = radamw.warmup_cosine(jnp.asarray(step), warmup=10, total=100)
    got = tadamw.warmup_cosine(torch.tensor(step), warmup=10, total=100)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=2e-7, atol=0)


def test_split_microbatches():
    x = np.arange(24, dtype=np.int32).reshape(8, 3)
    want = racc.split_microbatches({"x": jnp.asarray(x)}, 4)["x"]
    got = tacc.split_microbatches({"x": torch.from_numpy(x)}, 4)["x"]
    assert tuple(got.shape) == (4, 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(AssertionError):
        tacc.split_microbatches({"x": torch.from_numpy(x)}, 3)
