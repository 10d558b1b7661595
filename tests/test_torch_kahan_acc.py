"""Port parity: the elementwise compensated accumulate (kernel B7) and
the tree accumulators of ``repro_torch.core.kahan``.

Everything here is f32 adds in the reference's order, so it is held
BITWISE: the plain twin against ``repro.kernels.ops.kahan_accumulate``
(Pallas, interpret mode) and ``ref.kahan_acc_ref``; ``KahanState`` /
``tree_*`` against the reference's on one small parameter tree; on the
card, the CUDA kernel against the twin."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kahan as rk  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core import kahan as tk  # noqa: E402
from repro_torch.kernels import kahan_acc as tacc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _triple(shape, seed=17):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(shape).astype(np.float32) * np.float32(100)
    c = rng.standard_normal(shape).astype(np.float32) * np.float32(1e-5)
    u = rng.standard_normal(shape).astype(np.float32)
    return s, c, u


@pytest.mark.parametrize("shape", [(1024,), (100, 7), (512, 128)])
def test_twin_matches_reference_bitwise(shape):
    s, c, u = _triple(shape)
    ks, kc = rops.kahan_accumulate(jnp.asarray(s), jnp.asarray(c),
                                   jnp.asarray(u), interpret=True)
    rs, rc = jax.jit(rref.kahan_acc_ref)(s, c, u)
    ts, tc = torch.from_numpy(s.copy()), torch.from_numpy(c.copy())
    out = tops.kahan_accumulate(ts, tc, torch.from_numpy(u))
    assert out[0] is ts and out[1] is tc
    for want in ((ks, kc), (rs, rc)):
        np.testing.assert_array_equal(_bits(want[0]), _bits(ts.numpy()))
        np.testing.assert_array_equal(_bits(want[1]), _bits(tc.numpy()))
    ps, pc = tref.kahan_acc_ref(torch.from_numpy(s), torch.from_numpy(c),
                                torch.from_numpy(u))
    assert torch.equal(ps, ts) and torch.equal(pc, tc)


def test_long_chain_accuracy():
    """1000 accumulations of 1e-4 onto 1e4: the naive sum loses them,
    the compensated pair keeps them, bitwise the reference's chain."""
    n_steps, base, inc = 1000, 1e4, 1e-4
    s = torch.full((256,), base)
    c = torch.zeros(256)
    u = torch.full((256,), inc)
    naive = torch.full((256,), base)
    step = jax.jit(rref.kahan_acc_ref)
    rs, rc = jnp.full((256,), base, jnp.float32), jnp.zeros(256, jnp.float32)
    for _ in range(n_steps):
        tops.kahan_accumulate(s, c, u)
        naive = naive + u
        rs, rc = step(rs, rc, jnp.full((256,), inc, jnp.float32))
    exact = base + n_steps * inc
    comp_err = abs(float((s + c)[0]) - exact)
    naive_err = abs(float(naive[0]) - exact)
    assert comp_err < 1e-3
    assert naive_err > 10 * comp_err
    np.testing.assert_array_equal(_bits(rs), _bits(s.numpy()))
    np.testing.assert_array_equal(_bits(rc), _bits(c.numpy()))


def test_in_place_contract():
    s, c, u = _triple((300,), seed=3)
    ts, tc = torch.from_numpy(s.copy()), torch.from_numpy(c.copy())
    ptrs = (ts.data_ptr(), tc.data_ptr())
    out = tacc.kahan_acc_flat(ts, tc, torch.from_numpy(u))
    assert out[0] is ts and out[1] is tc
    assert (ts.data_ptr(), tc.data_ptr()) == ptrs
    want = rk.neumaier_step(jnp.asarray(s), jnp.asarray(c), jnp.asarray(u))
    np.testing.assert_array_equal(_bits(want[0]), _bits(ts.numpy()))
    # a bf16 update is widened to the accumulator's dtype
    ub = torch.from_numpy(u).to(torch.bfloat16)
    a = torch.from_numpy(s.copy()), torch.from_numpy(c.copy())
    b = torch.from_numpy(s.copy()), torch.from_numpy(c.copy())
    tacc.kahan_acc_flat(*a, ub)
    tacc.kahan_acc_flat(*b, ub.float())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the (M, 128) shim writes through its flat views
    s2, c2, u2 = (torch.from_numpy(x.copy()) for x in _triple((4, 128)))
    out = tacc.kahan_acc_blocked(s2, c2, u2)
    assert out[0] is s2 and out[0].shape == (4, 128)
    with pytest.raises(ValueError):
        tacc.kahan_acc_flat(s2, c2, u2)           # 2-D into the flat form
    with pytest.raises(ValueError):
        tops.kahan_accumulate(ts, tc, torch.zeros(7))


def _tree(seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s)                   # noqa: E731
                     * 2.0 ** rng.integers(-10, 10, s)).astype(np.float32)
    # keys in sorted order: jax.tree.leaves sorts dict keys, tree_leaves
    # keeps insertion order
    return {"embed": mk(6, 4), "final_norm": {"scale": mk(4)},
            "layers": [{"b": mk(4), "w": mk(4, 4)}, {"b": mk(4),
                                                      "w": mk(4, 4)}]}


def test_kahan_state_and_tree_ops_bitwise():
    updates = [_tree(s) for s in range(4)]
    to_j = lambda t: jax.tree.map(jnp.asarray, t)             # noqa: E731
    to_t = lambda t: tk.tree_map(torch.from_numpy, t)          # noqa: E731
    rst = rk.KahanState.zeros_like(to_j(updates[0]))
    tst = tk.KahanState.zeros_like(to_t(updates[0]))
    for u in updates[:3]:
        rst, tst = rst.add(to_j(u)), tst.add(to_t(u))
    other_r = rk.KahanState.zeros_like(to_j(updates[3])).add(to_j(updates[3]))
    other_t = tk.KahanState.zeros_like(to_t(updates[3])).add(to_t(updates[3]))
    rst, tst = rst.merge(other_r), tst.merge(other_t)
    for want, got in ((rst.sum, tst.sum), (rst.carry, tst.carry),
                      (rst.value(), tst.value())):
        w_leaves = jax.tree.leaves(want)
        g_leaves = tk.tree_leaves(got)
        assert len(w_leaves) == len(g_leaves) == 6
        for w, g in zip(w_leaves, g_leaves):
            np.testing.assert_array_equal(_bits(w), _bits(g.numpy()))
    s, c = tk.tree_kahan_add(tst.sum, tst.carry, to_t(updates[0]))
    rs, rc = rk.tree_kahan_add(rst.sum, rst.carry, to_j(updates[0]))
    for w, g in zip(jax.tree.leaves((rs, rc)), tk.tree_leaves((s, c))):
        np.testing.assert_array_equal(_bits(w), _bits(g.numpy()))


def test_naive_baselines_match_reference():
    x, y = _triple((257,), seed=5)[1:]
    np.testing.assert_allclose(
        float(tk.naive_dot(torch.from_numpy(x), torch.from_numpy(y))),
        float(rk.naive_dot(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)
    np.testing.assert_allclose(
        tk.naive_sum(torch.from_numpy(x.reshape(1, -1))).numpy(),
        np.asarray(rk.naive_sum(jnp.asarray(x.reshape(1, -1)))), rtol=1e-6)


def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    for n, off in ((1024, 0), (100 * 7 + 3, 0), (4099, 1)):
        s, c, u = (torch.from_numpy(x).cuda() for x in _triple((n + off,)))
        for ud in (torch.float32, torch.bfloat16):
            ws, wc = s[off:].clone(), c[off:].clone()
            gs, gc = s.clone()[off:], c.clone()[off:]   # off = 1: unaligned
            uu = u[off:].to(ud).contiguous()
            tacc.kahan_acc_flat_plain(ws, wc, uu)
            before = tops.launches["kahan_acc"]
            out = tacc.kahan_acc_flat_cuda(gs, gc, uu)
            assert tops.launches["kahan_acc"] == before + 1
            torch.cuda.synchronize()
            assert out[0] is gs
            assert torch.equal(gs, ws) and torch.equal(gc, wc)   # bitwise
    with pytest.raises(ValueError):
        tacc.kahan_acc_flat_cuda(*(torch.zeros(8, dtype=torch.float64,
                                               device="cuda"),) * 3)
