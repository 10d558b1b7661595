"""The whole slice: every entry point that ``repro.kernels`` publishes
(its ``__init__`` docstring's list, plus the ``*_blocked`` shims and the
``ref`` oracles) called through ``repro_torch.kernels`` on the CPU, on
the same seeded inputs as its JAX counterpart (Pallas in interpret
mode). Sums that copy the reference's stream layout, the accumulate and
the oracles are held bitwise; attention and the matmuls at the
tolerances of their own parity files.

Compensated DOTS are held at the compensated error bound, not bitwise:
XLA on the CPU may contract the product x * y into the first add of the
TwoSum (an FMA), so the reference's dot can differ from a rounded
product by an ulp. On these inputs it does (n = 3000: the reference
gives -2008.9141845703125, the port -2008.914306640625, the exact sum
is -2008.9144938...); the same products rounded first and summed agree
bitwise."""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.kernels as rker  # noqa: E402
import repro_torch.kernels as tker  # noqa: E402
from repro.kernels import kahan_dot as rkd  # noqa: E402
from repro.kernels import kahan_sum as rks  # noqa: E402
from repro.kernels import naive_dot as rnd  # noqa: E402
from repro.models import paged as rpaged  # noqa: E402
from repro.quant import core as rq  # noqa: E402
from repro_torch.kernels import kahan_dot as tkd  # noqa: E402
from repro_torch.kernels import kahan_sum as tks  # noqa: E402
from repro_torch.kernels import naive_dot as tnd  # noqa: E402
from repro_torch.kernels.engine import LANES  # noqa: E402

R, T = rker.ops, tker.ops


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * 2.0 ** rng.integers(-6, 6, shape)).astype(np.float32)


def _bitwise(want, got):
    np.testing.assert_array_equal(np.asarray(want, np.float32).view(np.uint32),
                                  np.asarray(got, np.float32).view(np.uint32))


def _compensated(want, got, terms):
    """Both within the compensated bound of each other: 4 ulp of the
    value plus 16 eps^2 sum |terms|."""
    eps = 2.0 ** -24
    tol = 4 * eps * np.abs(np.asarray(want, np.float64)) \
        + 16 * eps ** 2 * np.abs(terms).sum(axis=-1)
    assert np.all(np.abs(np.asarray(got, np.float64)
                         - np.asarray(want, np.float64)) <= tol)


def _close(want, got, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def case_kahan_dot():
    x, y = _x((3000,), 1), _x((3000,), 2)
    _compensated(R.kahan_dot(jnp.asarray(x), jnp.asarray(y), interpret=True),
                 T.kahan_dot(_t(x), _t(y)), x * y)


def case_kahan_sum():
    x = _x((70, 50), 3)
    _bitwise(R.kahan_sum(jnp.asarray(x), interpret=True), T.kahan_sum(_t(x)))


def case_naive_dot():
    # the naive baseline sums its partials in an order XLA picks
    x, y = _x((3000,), 4), _x((3000,), 5)
    bound = 64 * 2.0 ** -24 * float(np.abs(x * y).sum())
    _close(R.naive_dot(jnp.asarray(x), jnp.asarray(y), interpret=True),
           T.naive_dot(_t(x), _t(y)), bound)


def case_fused_reduce():
    x, y = _x((5000,), 6), _x((5000,), 7)
    outs = ("dot", "sum", "sumsq", "max", "maxabs")
    want = R.fused_reduce(jnp.asarray(x), jnp.asarray(y), outputs=outs,
                          interpret=True)
    got = T.fused_reduce(_t(x), _t(y), outputs=outs)
    for o in ("sum", "max", "maxabs"):
        _bitwise(want[o], got[o])
    _compensated(want["dot"], got["dot"], x * y)
    _compensated(want["sumsq"], got["sumsq"], x * x)


def case_batched_fused_reduce():
    x = _x((3, 1025), 8)
    outs = ("max", "sum", "sumsq")
    want = R.batched_fused_reduce(jnp.asarray(x), outputs=outs,
                                  interpret=True)
    got = T.batched_fused_reduce(_t(x), outputs=outs)
    _bitwise(want["max"], got["max"])
    _bitwise(want["sum"], got["sum"])
    _compensated(want["sumsq"], got["sumsq"], x * x)


def case_batched_kahan_dot():
    x, y = _x((4, 700), 9), _x((4, 700), 10)
    _compensated(R.batched_kahan_dot(jnp.asarray(x), jnp.asarray(y),
                                     interpret=True),
                 T.batched_kahan_dot(_t(x), _t(y)), x * y)


def case_kahan_accumulate():
    s, c, u = _x((100, 7), 11), _x((100, 7), 12) * 1e-6, _x((100, 7), 13)
    ws, wc = R.kahan_accumulate(jnp.asarray(s), jnp.asarray(c),
                                jnp.asarray(u), interpret=True)
    gs, gc = T.kahan_accumulate(_t(s), _t(c), _t(u))
    _bitwise(ws, gs)
    _bitwise(wc, gc)


def case_paged_attention():
    rng = np.random.default_rng(14)
    b, hq, hkv, d, bs, mb = 2, 4, 2, 16, 4, 3
    layout = rpaged.PagedLayout(bs, mb)
    rows = [rng.standard_normal((b, mb * bs, hkv, d)).astype(np.float32)
            for _ in range(2)]
    (qk, sk), (qv, sv) = (rq.quantize_lastdim(jnp.asarray(r), rq.INT8)
                          for r in rows)
    pools = [np.asarray(rpaged.pool_from_rows(a, layout))
             for a in (qk, qv, sk, sv)]
    table = np.asarray(rpaged.identity_table(b, layout))
    lens = np.array([5, mb * bs], np.int32)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    want = R.paged_attention(*(jnp.asarray(a) for a in (q, *pools[:2], table,
                                                        lens)),
                             kscale=jnp.asarray(pools[2]),
                             vscale=jnp.asarray(pools[3]), interpret=True)
    got = T.paged_attention(_t(q), _t(pools[0]), _t(pools[1]), _t(table),
                            _t(lens), kscale=_t(pools[2]),
                            vscale=_t(pools[3]))
    _close(want, got, 1e-5)


def case_q8_matmul():
    a, w = _x((8, 512), 15), _x((512, 128), 16)
    qw, s = rq.quantize_weight(jnp.asarray(w), block_k=256)
    want = R.q8_matmul(jnp.asarray(a), qw, s, interpret=True)
    got = T.q8_matmul(_t(a), _t(qw), _t(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


def case_kahan_matmul():
    a, b = _x((64, 256), 17), _x((256, 128), 18)
    want = rker.kahan_matmul(jnp.asarray(a), jnp.asarray(b), block_m=64,
                             block_n=64, block_k=64, interpret=True)
    got = tker.kahan_matmul(_t(a), _t(b), block_m=64, block_n=64,
                            block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5 * 16 * float(np.abs(a).max()
                                                      * np.abs(b).max()),
                               rtol=1e-5)


def case_flash_attention():
    q, k, v = _x((2, 70, 32), 19), _x((2, 90, 32), 20), _x((2, 90, 32), 21)
    want = rker.flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True,
                                       q_block=32, kv_block=64,
                                       interpret=True)
    got = tker.flash_attention(_t(q), _t(k), _t(v), causal=True, q_block=32,
                               kv_block=64)
    _close(want, got, 2e-5)


def case_blocked_shims():
    x, y = _x((96, 128), 22), _x((96, 128), 23)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    _compensated(rkd.kahan_dot_blocked(jx, jy, interpret=True),
                 tkd.kahan_dot_blocked(_t(x), _t(y)), (x * y).ravel())
    _bitwise(rks.kahan_sum_blocked(jx, interpret=True),
             tks.kahan_sum_blocked(_t(x)))
    bound = 64 * 2.0 ** -24 * float(np.abs(x * y).sum())
    _close(rnd.naive_dot_blocked(jx, jy, interpret=True),
           tnd.naive_dot_blocked(_t(x), _t(y)), bound)
    with pytest.raises(ValueError):
        tkd.kahan_dot_blocked(_t(x[:, :100]), _t(y[:, :100]))


def case_ref_oracles():
    rr, tr = rker.ref, tker.ref
    x, y = _x((300,), 24), _x((300,), 25)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), _t(x), _t(y)
    _bitwise(rr.kahan_dot_ref(jx, jy), tr.kahan_dot_ref(tx, ty))
    _bitwise(rr.kahan_sum_ref(jx), tr.kahan_sum_ref(tx))
    bound = 300 * 2.0 ** -24 * float(np.abs(x * y).sum())
    _close(rr.naive_dot_ref(jx, jy), tr.naive_dot_ref(tx, ty), bound)
    _close(rr.naive_sum_ref(jx), tr.naive_sum_ref(tx),
           300 * 2.0 ** -24 * float(np.abs(x).sum()))
    for w, g in zip(rr.kahan_acc_ref(jx, jy, jx), tr.kahan_acc_ref(tx, ty,
                                                                   tx)):
        _bitwise(w, g)
    assert rr.exact_dot(x, y) == tr.exact_dot(tx, ty)
    assert rr.exact_sum(x) == tr.exact_sum(tx)
    assert rr.condition_number(x) == tr.condition_number(tx)


def _ill_conditioned(m, seed):
    """(m, 128) f32: +-1e6 pairs that cancel exactly plus unit normals,
    shuffled; sum|x| ~ 1e11 against a sum of a few hundred, so a
    different stream layout changes the last bits of the compensated
    sum."""
    rng = np.random.default_rng(seed)
    n = m * LANES
    a = rng.standard_normal(n // 3) * 1e6
    x = np.concatenate([a, -a, rng.standard_normal(n - 2 * (n // 3))])
    x = x.astype(np.float32)
    rng.shuffle(x)
    return x.reshape(m, LANES)


@pytest.mark.parametrize("shim", ["kahan_sum", "kahan_dot", "naive_dot"])
@pytest.mark.parametrize("block_rows,unroll", [
    (None, None), (64, 1), (64, 2), (64, 4), (256, 1), (256, 2), (256, 4),
    (512, 1), (512, 2), (512, 4)])
def test_blocked_shims_follow_reference_schedule(shim, block_rows, unroll):
    """The ``*_blocked`` shims at the reference's defaults (None: 256 rows
    for the dots, 512 for the sum) and at explicit ``block_rows`` /
    ``unroll``, on 2048 x 128 ill-conditioned rows: the compensated sum and
    dot bitwise the reference's, the naive dot at the naive bound (XLA
    orders a block's sums). With the engine's default blocks instead of
    512-row ones, ``kahan_sum_blocked`` differs from the reference here."""
    x, y = _ill_conditioned(2048, 2), _ill_conditioned(2048, 3)
    kw = {} if block_rows is None else dict(block_rows=block_rows,
                                            unroll=unroll)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    if shim == "kahan_sum":
        _bitwise(rks.kahan_sum_blocked(jx, interpret=True, **kw),
                 tks.kahan_sum_blocked(_t(x), **kw))
    elif shim == "kahan_dot":
        _bitwise(rkd.kahan_dot_blocked(jx, jy, interpret=True, **kw),
                 tkd.kahan_dot_blocked(_t(x), _t(y), **kw))
    else:
        rkw = {k: v for k, v in kw.items() if k == "block_rows"}
        bound = 2100 * 2.0 ** -24 * float(np.abs(x * y).astype(
            np.float64).sum())
        want = float(rnd.naive_dot_blocked(jx, jy, interpret=True, **rkw))
        got = float(tnd.naive_dot_blocked(_t(x), _t(y), **kw))
        assert abs(got - want) <= bound
    if block_rows is None and shim == "kahan_sum":
        (engine_default,) = tker.engine.fused_reduce_flat_plain(
            (_t(x).reshape(-1),), outputs=("sum",))
        assert float(engine_default) != float(tks.kahan_sum_blocked(_t(x)))


def test_ops_take_the_reference_knobs():
    """``ops.kahan_dot`` / ``kahan_sum`` / ``naive_dot`` take
    ``block_rows`` and ``unroll``, the fused forms ``unroll``, mapped as
    the reference maps them: compensated results bitwise."""
    x, y = _ill_conditioned(600, 3), _ill_conditioned(600, 4)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), _t(x), _t(y)
    for kw in (dict(block_rows=64, unroll=2), dict(block_rows=512),
               dict(unroll=1)):
        _bitwise(R.kahan_sum(jx, interpret=True, **kw),
                 T.kahan_sum(tx, **kw))
        _bitwise(R.kahan_dot(jx, jy, interpret=True, **kw),
                 T.kahan_dot(tx, ty, **kw))
        bound = 2100 * 2.0 ** -24 * float(np.abs(x * y).astype(
            np.float64).sum())
        assert abs(float(R.naive_dot(jx, jy, interpret=True, **kw))
                   - float(T.naive_dot(tx, ty, **kw))) <= bound
    for u in (1, 2):
        _bitwise(R.batched_kahan_dot(jx, jy, unroll=u, interpret=True),
                 T.batched_kahan_dot(tx, ty, unroll=u))
        want = R.fused_reduce(jx, outputs=("sum", "sumsq"), unroll=u,
                              interpret=True)
        got = T.fused_reduce(tx, outputs=("sum", "sumsq"), unroll=u)
        for k in want:
            _bitwise(want[k], got[k])
        want = R.batched_fused_reduce(jx, outputs=("sum",), unroll=u,
                                      interpret=True)
        _bitwise(want["sum"], T.batched_fused_reduce(tx, outputs=("sum",),
                                                     unroll=u)["sum"])


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("entry", sorted(CASES))
def test_entry_point_matches_reference(entry):
    before = dict(T.launches)
    CASES[entry]()
    assert T.launches == before        # CPU tensors launch no kernel


def test_public_surface():
    for name in ("engine", "ops", "ref", "kahan_matmul", "flash_attention"):
        assert hasattr(tker, name), name
    for name in ("kahan_dot", "kahan_sum", "naive_dot", "fused_reduce",
                 "batched_fused_reduce", "batched_kahan_dot",
                 "kahan_accumulate", "paged_attention", "q8_matmul"):
        assert callable(getattr(T, name)), name
    assert set(T.launches) == {"fused_reduce", "paged_attention",
                               "paged_latent_attention",
                               "flash_attention_wgmma",
                               "flash_attention_wgmma_f32", "kahan_matmul",
                               "kahan_matmul_q8", "kahan_acc",
                               "kahan_matmul_split",
                               "kahan_matmul_q8_split", "serving_head",
                               "row_norm", "invariant_gemm"}
