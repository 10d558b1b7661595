"""Port parity: the compensated K-block matmul (kernel B5), its
quantized-weight form (B6) and the weight / block quantizers.

The plain twins follow the reference's K blocking, so they are held to
``repro.kernels.kahan_matmul`` (Pallas, interpret mode) at the
reference test's tolerance (``tol * sqrt(K)``; within a block the f32
partial is summed in another order). The int8 q8 path is held to
``repro.kernels.ops.q8_matmul``; the fp8 path to ``dequantize_weight``
then an f32 matmul (the reference kernel reads fp8 bytes as integers).
The quantizers are held BITWISE. On the card, the CUDA kernels against
the twins."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.kahan_matmul import kahan_matmul as rkm  # noqa: E402
from repro.quant import core as rq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.kahan_matmul import (  # noqa: E402
    kahan_matmul, kahan_matmul_cuda, kahan_matmul_plain, kahan_matmul_q8_cuda,
    kahan_matmul_q8_plain)
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


def _deep_case():
    rng = np.random.default_rng(1)
    m = n = 8
    k = 1 << 14
    scales = 10.0 ** rng.integers(-3, 4, (1, k))
    a = (rng.standard_normal((m, k)) * scales).astype(np.float32)
    b = (rng.standard_normal((k, n)) * scales.T).astype(np.float32)
    return a, b


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


def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    from repro_torch import device
    device.set_numerics()
    for m, k, n, bm, bn, bk in GRID + [(8, 2816, 1024, 8, 256, 256)]:
        for dt in (torch.float32, torch.bfloat16):
            a = torch.from_numpy(_normal((m, k), 8)).to(dt).cuda()
            b = torch.from_numpy(_normal((k, n), 9)).to(dt).cuda()
            kw = dict(block_m=bm, block_n=bn, block_k=bk)
            before = tops.launches["kahan_matmul"]
            got = kahan_matmul_cuda(a, b, **kw)
            assert tops.launches["kahan_matmul"] == before + 1
            want = kahan_matmul_plain(a, b, **kw)
            # both f32 with the same block folds; the block partials are
            # summed in other orders: the reference test's f32 tolerance
            torch.testing.assert_close(got, want, atol=1e-5 * k ** 0.5,
                                       rtol=1e-5)
    a, b = (torch.from_numpy(x).cuda() for x in _deep_case())
    got = kahan_matmul_cuda(a, b, block_m=8, block_n=8, block_k=128)
    want = a.double() @ b.double()
    naive = a @ b
    assert (got.double() - want).abs().max() <= \
        1.5 * (naive.double() - want).abs().max() + 1e-6
    for fmt in (tq.INT8, tq.FP8):
        for m in (8, 64 + 3):
            a = torch.from_numpy(_normal((m, 512), 10)).cuda()
            qw, s = tq.quantize_weight(torch.from_numpy(_normal((512, 192),
                                                                11)).cuda(),
                                       fmt, block_k=128)
            before = tops.launches["kahan_matmul_q8"]
            got = kahan_matmul_q8_cuda(a, qw, s, block_m=m)
            assert tops.launches["kahan_matmul_q8"] == before + 1
            want = kahan_matmul_q8_plain(a, qw, s, block_m=m)
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
