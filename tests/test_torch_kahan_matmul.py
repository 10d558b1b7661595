"""Port parity: the compensated K-block matmul (kernel B5), its
quantized-weight form (B6) and the weight / block quantizers.

The plain twins follow the reference's K blocking, so they are held to
``repro.kernels.kahan_matmul`` (Pallas, interpret mode) at the
reference test's tolerance (``tol * sqrt(K)``; within a block the f32
partial is summed in another order). The int8 q8 path is held to
``repro.kernels.ops.q8_matmul``; the fp8 path to ``dequantize_weight``
then an f32 matmul (the reference kernel reads fp8 bytes as integers).
The quantizers are held BITWISE. The tensor-core route's arithmetic is
emulated here (exact bf16 planes of f32 operands, the plane products it
issues, f32 block partials, the fold) and held to the same references
at the same tolerances. On the card, both CUDA routes against the
twins."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.kahan_matmul import kahan_matmul as rkm  # noqa: E402
from repro.kernels.kahan_matmul import kahan_matmul_q8 as rkm_q8  # noqa: E402
from repro.quant import core as rq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.core import kahan as tkahan  # noqa: E402
from repro_torch.kernels.kahan_matmul import (  # noqa: E402
    DEEP_CASE_Q8_REFERENCE_ERR, DEEP_CASE_REFERENCE_ERR, SPLIT_MAX_M,
    deep_case, kahan_matmul,
    kahan_matmul_cuda, kahan_matmul_plain, kahan_matmul_q8_cuda,
    kahan_matmul_q8_plain, pick_route, split_parts, tensor_passes)
from repro_torch.quant import core as tq  # noqa: E402

GRID = [(128, 256, 128, 128, 128, 128), (256, 1024, 128, 128, 128, 256),
        (128, 128, 128, 64, 64, 32)]


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("m,k,n,bm,bn,bk", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_reference(m, k, n, bm, bn, bk, dtype):
    a, b = _normal((m, k), 0), _normal((k, n), 1)
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    want = np.asarray(rkm(ja, jb, block_m=bm, block_n=bn, block_k=bk,
                          interpret=True))
    tdt = getattr(torch, dtype)
    got = kahan_matmul(torch.from_numpy(a).to(tdt), torch.from_numpy(b)
                       .to(tdt), block_m=bm, block_n=bn, block_k=bk)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), want, atol=tol * np.sqrt(k),
                               rtol=tol)
    exact = (np.asarray(ja, np.float32).astype(np.float64)
             @ np.asarray(jb, np.float32).astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, atol=tol * np.sqrt(k),
                               rtol=tol)


_deep_case = deep_case


@pytest.mark.parametrize("m", sorted(DEEP_CASE_REFERENCE_ERR))
def test_reference_deep_error_is_pinned(m):
    """The reference's own error on the deep case at bk = 128, which the
    card-side checks hold route T (M = 72) and route S (M = 8) to, since
    the card cannot run the reference: pinned here with the twin's and the
    route T emulation's, both within 2x of it, and naive f32's, at least
    2x it."""
    a, b = _deep_case(m)
    exact = np.float64(a) @ np.float64(b)
    ref = np.asarray(rkm(jnp.asarray(a), jnp.asarray(b), block_m=m,
                         block_n=8, block_k=128, interpret=True))
    err_r = np.abs(ref - exact).max()
    assert abs(err_r - DEEP_CASE_REFERENCE_ERR[m]) <= \
        1e-3 * DEEP_CASE_REFERENCE_ERR[m]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    naive = np.abs((ta @ tb).numpy() - exact).max()
    assert naive >= 2 * err_r
    twin = kahan_matmul_plain(ta, tb, block_m=m, block_n=8,
                              block_k=128).numpy()
    emul = _emulate_tile(ta, tb, 128).numpy()
    assert np.abs(twin - exact).max() <= 2 * err_r
    assert np.abs(emul - exact).max() <= 2 * err_r


@pytest.mark.parametrize("fmt_name,m", sorted(DEEP_CASE_Q8_REFERENCE_ERR))
def test_reference_deep_q8_error_is_pinned(fmt_name, m):
    """The reference q8 kernel's own error on the deep case with B
    quantized per 128-row block (f32 x 8-bit: route T's three plane
    products), pinned for the card-side measurements, with the twin's and
    the route T emulation's within 2x of it and naive f32's at least 2x
    it. The fp8 payload goes to the reference as float8_e4m3fn, which it
    widens as e4m3."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    a, b = _deep_case(m)
    qw, s = tq.quantize_weight(torch.from_numpy(b), tq.get_format(fmt_name),
                               block_k=128)
    deq = tq.dequantize_weight(qw, s)
    exact = np.float64(a) @ deq.double().numpy()
    payload = qw.numpy() if fmt_name == "int8" else \
        qw.numpy().view(ml_dtypes.float8_e4m3fn)
    ref = np.asarray(rkm_q8(jnp.asarray(a), jnp.asarray(payload),
                            jnp.asarray(s.numpy()), block_m=m, block_n=8,
                            interpret=True))
    err_r = np.abs(ref - exact).max()
    pinned = DEEP_CASE_Q8_REFERENCE_ERR[(fmt_name, m)]
    assert abs(err_r - pinned) <= 1e-3 * pinned
    ta = torch.from_numpy(a)
    assert np.abs((ta @ deq).numpy() - exact).max() >= 2 * err_r
    twin = kahan_matmul_q8_plain(ta, qw, s, block_m=m, block_n=8).numpy()
    emul = _emulate_tile(ta, qw, 128, s).numpy()
    assert np.abs(twin - exact).max() <= 2 * err_r
    assert np.abs(emul - exact).max() <= 2 * err_r


def test_deep_contraction_beats_naive():
    a, b = _deep_case()
    got = kahan_matmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                             block_m=8, block_n=8, block_k=128).numpy()
    naive = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy()
    want = np.float64(a) @ np.float64(b)
    err_k = np.abs(got - want).max()
    err_n = np.abs(naive - want).max()
    assert err_k <= err_n * 1.5 + 1e-6
    assert err_k <= 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("m,k,n", [(8, 512, 128), (16, 256, 256)])
def test_q8_int8_matches_reference(m, k, n):
    a, w = _normal((m, k), 2), _normal((k, n), 3)
    qw, s = rq.quantize_weight(jnp.asarray(w), block_k=256)
    want = np.asarray(rops.q8_matmul(jnp.asarray(a), qw, s, interpret=True))
    tqw = torch.from_numpy(np.array(qw))
    got = tops.q8_matmul(torch.from_numpy(a), tqw,
                         torch.from_numpy(np.array(s))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    oracle = a @ np.asarray(rq.dequantize_weight(qw, s))
    np.testing.assert_allclose(got, oracle, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("m,k,n", [(8, 512, 128), (16, 256, 256)])
def test_q8_fp8_matches_dequant_oracle(m, k, n):
    a, w = _normal((m, k), 4), _normal((k, n), 5)
    qw, s = tq.quantize_weight(torch.from_numpy(w), tq.FP8, block_k=256)
    assert qw.dtype == torch.uint8
    got = tops.q8_matmul(torch.from_numpy(a), qw, s)
    want = torch.from_numpy(a) @ tq.dequantize_weight(qw, s)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-5)
    # the port widens fp8 as e4m3, so the result is not the byte values'
    as_bytes = torch.from_numpy(a) @ (qw.float().reshape(-1, 256, n)
                                      * s[:, None]).reshape(k, n)
    assert float((got - as_bytes).abs().max()) > 1.0


@pytest.mark.parametrize("fmt_name", ["int8", "fp8"])
def test_quantizers_bitwise(fmt_name):
    w = _normal((512, 96), 6) * np.float32(3)
    w[:256, 0] = 0.0                          # an all-zero tile: eps scale
    rf, tf = rq.get_format(fmt_name), tq.get_format(fmt_name)
    rqw, rs = rq.quantize_weight(jnp.asarray(w), rf, block_k=128)
    tqw, ts = tq.quantize_weight(torch.from_numpy(w), tf, block_k=128)
    assert tqw.dtype == tf.storage and ts.shape == (4, 96)
    np.testing.assert_array_equal(np.asarray(rqw).view(np.uint8),
                                  tqw.numpy().view(np.uint8))
    np.testing.assert_array_equal(np.asarray(rs), ts.numpy())
    np.testing.assert_array_equal(
        np.asarray(rq.dequantize_weight(rqw, rs)),
        tq.dequantize_weight(tqw, ts).numpy())
    x = _normal((1000,), 7)                   # 1000 = 3 x 256 + 232 pad
    rb, rbs, rpad = rq.quantize_blocks(jnp.asarray(x), rf)
    tb, tbs, tpad = tq.quantize_blocks(torch.from_numpy(x), tf)
    assert rpad == tpad == 24
    np.testing.assert_array_equal(np.asarray(rb).view(np.uint8),
                                  tb.numpy().view(np.uint8))
    np.testing.assert_array_equal(np.asarray(rbs), tbs.numpy())
    np.testing.assert_array_equal(
        np.asarray(rq.dequantize_blocks(rb, rbs, rpad, (1000,))),
        tq.dequantize_blocks(tb, tbs, tpad, (1000,)).numpy())


def test_shapes_are_checked():
    a, b = torch.zeros(8, 96), torch.zeros(96, 64)
    with pytest.raises(ValueError):
        kahan_matmul(a, b, block_k=64)             # 64 does not divide 96
    with pytest.raises(ValueError):
        kahan_matmul(a, torch.zeros(95, 64))
    with pytest.raises(ValueError):
        tops.q8_matmul(a, torch.zeros(96, 64, dtype=torch.int8),
                       torch.zeros(5, 64))
    before = dict(tops.launches)
    kahan_matmul(a, b, block_k=32)
    assert tops.launches == before                 # the CPU twin is no launch


# ------------------------------------------- route T's arithmetic on CPU --
# Route T feeds the bf16 tensor cores bf16 planes that sum exactly to
# each operand: hi = bf16(x), mid = bf16(x - hi), lo = x - hi - mid.

# the range where hi + mid + lo == x holds: lo and mid stay in bf16's
# normal range from 2^-103 up, hi stays finite below (2 - 2^-8) 2^127
SPLIT_MIN, SPLIT_MAX = 2.0 ** -103, (2 - 2.0 ** -8) * 2.0 ** 127


def _split3(x):
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, r - mid


def _assert_exact_split(x):
    hi, mid, lo = _split3(x)
    for p in (hi, mid, lo):                  # every plane is a bf16 value
        assert torch.equal(p.to(torch.bfloat16).float(), p)
    assert torch.equal((hi + mid + lo).view(torch.int32), x.view(torch.int32))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_plane_split_exact_normals(scale):
    x = torch.from_numpy(_normal((4096,), 20)) * scale
    _assert_exact_split(x)


def test_plane_split_exact_over_magnitudes():
    rng = np.random.default_rng(21)
    mag = 10.0 ** rng.uniform(-30, 30, 20000)
    sign = rng.choice([-1.0, 1.0], 20000)
    x = torch.from_numpy((sign * mag).astype(np.float32))
    assert float(x.abs().min()) >= SPLIT_MIN
    _assert_exact_split(x)
    # the ends of the stated range
    ends = torch.tensor([SPLIT_MIN, -SPLIT_MIN, 3.38e38, -3.38e38,
                         np.finfo(np.float32).tiny * 2.0 ** 23],
                        dtype=torch.float32)
    _assert_exact_split(ends)


def test_plane_split_zeros_infs_nans():
    z = torch.tensor([0.0, -0.0])
    hi, mid, lo = _split3(z)
    assert torch.equal(hi.view(torch.int32), z.view(torch.int32))
    assert torch.equal(mid, torch.zeros(2)) and torch.equal(lo, torch.zeros(2))
    assert torch.equal(hi + mid + lo, z)     # == by value (-0 sums to +0)
    # outside the range: hi carries inf / NaN, the other planes are NaN,
    # so a product with them is NaN (the reference would give inf or NaN)
    special = torch.tensor([float("inf"), float("-inf"), float("nan")])
    hi, mid, lo = _split3(special)
    assert torch.equal(hi[:2], special[:2]) and bool(hi[2].isnan())
    assert bool(mid.isnan().all()) and bool(lo.isnan().all())


def _planes(x):
    """An operand's bf16 planes as f32, largest first: three for f32,
    one for bf16 and for a widened int8 / fp8 payload."""
    if x.dtype == torch.float32:
        return _split3(x)
    return (tq.cast_f32(x) if x.dtype in (torch.int8, torch.uint8)
            else x.float(),)


def _emulate_tile(a, b, bk, scales=None):
    """Route T's arithmetic: per K block, the plane products of the
    kernel smallest first into a 'small' f32 sum and hi.hi into a 'big'
    one, the partial big + small (times the block's scales), then the
    Neumaier fold; f32 matmuls stand in for the tensor cores' sums."""
    pa, pb = _planes(a), _planes(b)
    pairs = sorted(((i, j) for i in range(len(pa)) for j in range(len(pb))
                    if i + j <= 2), key=lambda ij: -(ij[0] + ij[1]))
    assert len(pairs) == tensor_passes(a.dtype, b.dtype)
    m, k = a.shape
    s = torch.zeros((m, b.shape[1]))
    c = torch.zeros_like(s)
    for blk in range(k // bk):
        ks = slice(blk * bk, (blk + 1) * bk)
        small = torch.zeros_like(s)
        for i, j in pairs[:-1]:
            small = small + pa[i][:, ks] @ pb[j][ks]
        part = pa[0][:, ks] @ pb[0][ks] + small
        if scales is not None:
            part = part * scales[blk]
        s, c = tkahan.neumaier_step(s, c, part)
    return s + c


@pytest.mark.parametrize("m,k,n,bm,bn,bk", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_emulation_matches_reference(m, k, n, bm, bn, bk, dtype):
    a, b = _normal((m, k), 0), _normal((k, n), 1)
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    want = np.asarray(rkm(ja, jb, block_m=bm, block_n=bn, block_k=bk,
                          interpret=True))
    tdt = getattr(torch, dtype)
    got = _emulate_tile(torch.from_numpy(a).to(tdt),
                        torch.from_numpy(b).to(tdt), bk)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), want, atol=tol * np.sqrt(k),
                               rtol=tol)


def test_tile_emulation_deep_contraction_beats_naive():
    a, b = _deep_case()
    got = _emulate_tile(torch.from_numpy(a), torch.from_numpy(b),
                        128).numpy()
    naive = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy()
    want = np.float64(a) @ np.float64(b)
    err_k = np.abs(got - want).max()
    err_n = np.abs(naive - want).max()
    assert err_k <= err_n * 1.5 + 1e-6
    assert err_k <= 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("m,k,n", [(8, 512, 128), (16, 256, 256)])
@pytest.mark.parametrize("fmt_name", ["int8", "fp8"])
@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
def test_tile_emulation_q8(m, k, n, fmt_name, a_dtype):
    a, w = _normal((m, k), 2), _normal((k, n), 3)
    tqw, ts = tq.quantize_weight(torch.from_numpy(w),
                                 tq.get_format(fmt_name), block_k=256)
    ta = torch.from_numpy(a).to(getattr(torch, a_dtype))
    got = _emulate_tile(ta, tqw, k // ts.shape[0], ts).numpy()
    oracle = ta.double() @ tq.dequantize_weight(tqw, ts).double()
    np.testing.assert_allclose(got, oracle.numpy(), atol=1e-4, rtol=1e-5)
    if fmt_name == "int8" and a_dtype == "float32":
        rqw, rs = rq.quantize_weight(jnp.asarray(w), block_k=256)
        want = np.asarray(rops.q8_matmul(jnp.asarray(a), rqw, rs,
                                         interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_route_pick_and_passes():
    assert pick_route(1) == pick_route(SPLIT_MAX_M) == "split"
    assert pick_route(SPLIT_MAX_M + 1) == pick_route(2048) == "tile"
    with pytest.raises(ValueError):         # route S holds M <= 64 rows
        split_parts(torch.zeros(SPLIT_MAX_M + 1, 16), torch.zeros(16, 16), 16)
    f32, bf16 = torch.float32, torch.bfloat16
    assert tensor_passes(f32, f32) == 6
    assert tensor_passes(f32, torch.int8) == tensor_passes(bf16, f32) == 3
    assert tensor_passes(bf16, bf16) == tensor_passes(bf16, torch.uint8) == 1


# ------------------------------------------------------------- on the card --

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    from repro_torch import device
    device.set_numerics()


def _counted(name, fn):
    before = tops.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert tops.launches[name] == before + 1, name
    return out


def _route_counter(m, q8=False):
    name = "kahan_matmul_q8" if q8 else "kahan_matmul"
    return name + ("_split" if pick_route(m) == "split" else "")


def test_cuda_kernel_matches_plain():
    _card()
    # M picks the route: 8 and 61 (eight row groups, the last ragged) on
    # route S, 64 + 3, 2048 and GRID's on route T; bk = 24 is not a
    # multiple of 16
    cases = GRID + [(8, 2816, 1024, 8, 256, 256), (67, 120, 100, 67, 100, 24),
                    (61, 120, 100, 61, 100, 24),
                    (2048, 2816, 1024, 256, 256, 256)]
    for m, k, n, bm, bn, bk in cases:
        for dt in (torch.float32, torch.bfloat16):
            a = torch.from_numpy(_normal((m, k), 8)).to(dt).cuda()
            b = torch.from_numpy(_normal((k, n), 9)).to(dt).cuda()
            kw = dict(block_m=bm, block_n=bn, block_k=bk)
            want = kahan_matmul_plain(a, b, **kw)
            got = _counted(_route_counter(m),
                           lambda: kahan_matmul_cuda(a, b, **kw))
            # both f32 with the same block folds; the block partials are
            # summed in other orders: the reference test's f32 tolerance
            torch.testing.assert_close(got, want, atol=1e-5 * k ** 0.5,
                                       rtol=1e-5)
    for m in (8, 72):                       # route S, route T
        a, b = (torch.from_numpy(x).cuda() for x in _deep_case(m))
        want = a.double() @ b.double()
        naive = a @ b
        got = _counted(_route_counter(m), lambda: kahan_matmul_cuda(
            a, b, block_m=m, block_n=8, block_k=128))
        err = (got.double() - want).abs().max()
        assert err <= 1.5 * (naive.double() - want).abs().max() + 1e-6
        # and within 2x of the reference's own error on these inputs
        assert err <= 2 * DEEP_CASE_REFERENCE_ERR[m]
    for fmt in (tq.INT8, tq.FP8):
        for m, k, bk in ((8, 512, 128), (64 + 3, 512, 128), (2048, 512, 128),
                         (67, 120, 24), (61, 120, 24)):
            for adt in (torch.float32, torch.bfloat16):
                a = torch.from_numpy(_normal((m, k), 10)).to(adt).cuda()
                qw, s = tq.quantize_weight(torch.from_numpy(
                    _normal((k, 192), 11)).cuda(), fmt, block_k=bk)
                want = kahan_matmul_q8_plain(a, qw, s, block_m=m)
                got = _counted(_route_counter(m, True),
                               lambda: kahan_matmul_q8_cuda(a, qw, s,
                                                            block_m=m))
                torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def test_cuda_split_route_is_the_serial_fold():
    """Route S folds the same partials in block order: bitwise the serial
    Neumaier fold of its own partials (not a combine of split pairs)."""
    _card()
    for m, k, n, bk, q8 in ((8, 2816, 1024, 256, False),
                            (8, 2816, 1024, 256, True),
                            (67 - 64, 120, 100, 24, False),
                            (61, 120, 100, 24, True)):
        a = torch.from_numpy(_normal((m, k), 12)).cuda()
        if q8:
            b, s = tq.quantize_weight(torch.from_numpy(
                _normal((k, n), 13)).cuda(), tq.INT8, block_k=bk)
        else:
            b, s = torch.from_numpy(_normal((k, n), 13)).cuda(), None
        out, ws = split_parts(a, b, bk, s)
        assert ws.shape == (k // bk, m, n)
        acc_s = torch.zeros((m, n), device="cuda")
        acc_c = torch.zeros_like(acc_s)
        for part in ws:
            acc_s, acc_c = tkahan.neumaier_step(acc_s, acc_c, part)
        assert torch.equal(out, acc_s + acc_c)
