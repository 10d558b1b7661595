"""Port parity: flash attention (kernel B4).

The plain twin walks the reference's (qc, kc) blocks, so it is held to
``repro.kernels.flash_attention.flash_attention_pallas`` (interpret
mode) at the reference test's tolerance (f32 2e-5, bf16 2e-2: the same
online-softmax steps, matmuls summed in other orders). Causal is the
Pallas kernel's top-left mask (q_pos >= k_pos), pinned with Lq != Lk,
where it differs from the bottom-right mask of the reference test's
oracle. On the card, each CUDA route against the twin: inputs whose D
and Dv are multiples of 16 up to 128 take the tensor cores, bf16
(``flash_attention_wgmma``, p rounded to bf16 for P V) and f32
(``flash_attention_wgmma_f32``, exact bf16 planes), other head dims the
CUDA-core kernel (``flash_attention``); the CPU tests pin which route
each call takes and what the wrapper refuses, and emulate the f32
tensor-core route's arithmetic (planes, six plane products, 64-key
tiles) against the reference at its f32 tolerance."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as rfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_cuda, flash_attention_plain, route,
    tile_mask)

CASES = [
    (256, 256, 64, 128, 128, True),
    (128, 384, 64, 128, 128, False),     # cross-attention shape
    (256, 256, 32, 64, 128, True),       # uneven blocks
    (100, 100, 64, 64, 64, True),
    (130, 257, 64, 64, 64, False),       # ragged
    (3, 7, 64, 64, 64, False),           # single partial block each way
]


def _qkv(lq, lk, d, dtype, seed=0, bh=3):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((bh, n, d)).astype(np.float32)
            for n in (lq, lk, lk)]
    j = [jnp.asarray(a, dtype) for a in arrs]
    t = [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))
         for x in j]
    return j, t


@pytest.mark.parametrize("lq,lk,d,qb,kb,causal", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_reference(lq, lk, d, qb, kb, causal, dtype):
    j, t = _qkv(lq, lk, d, dtype)
    want = rfa.flash_attention_pallas(*j, causal=causal, q_block=qb,
                                      kv_block=kb, interpret=True)
    got = flash_attention(*t, causal=causal, q_block=qb, kv_block=kb)
    assert got.dtype == t[0].dtype and got.shape == (3, lq, d)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("lq,lk", [(100, 40), (40, 100)])
def test_causal_is_top_left(lq, lk):
    j, t = _qkv(lq, lk, 32, "float32", seed=1)
    want = np.asarray(rfa.flash_attention_pallas(*j, causal=True,
                                                 q_block=64, kv_block=32,
                                                 interpret=True))
    got = flash_attention_plain(*t, causal=True, q_block=64,
                                kv_block=32).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    # top-left: row 0 attends key 0 only, so it IS v[:, 0]
    np.testing.assert_allclose(got[:, 0], t[2][:, 0].numpy(), atol=1e-6)
    # and a bottom-right mask (tril(k = lk - lq)) gives other rows
    q, k, v = (x.double() for x in t)
    s = q @ k.transpose(1, 2) * 32 ** -0.5
    br = torch.ones(lq, lk, dtype=torch.bool).tril(lk - lq)
    other = torch.softmax(s.masked_fill(~br, -1e30), -1) @ v
    assert np.abs(other.numpy() - got).max() > 1e-2


def test_tile_mask_helper():
    assert tile_mask(0, 0, 4, 4) is None
    m = tile_mask(2, 0, 3, 8, causal=True, k_limit=6)
    want = (np.arange(2, 5)[:, None] >= np.arange(8)[None, :]) \
        & (np.arange(8)[None, :] < 6)
    assert np.array_equal(m.numpy(), want)
    m = tile_mask(0, 4, 2, 4, k_limit=6)
    assert np.array_equal(m.numpy(),
                          (4 + np.arange(4))[None, :].repeat(2, 0) < 6)
    for args, kw in [((3, 5, 4, 6), dict(causal=True, q_limit=6)),
                     ((0, 0, 5, 5), dict(q_limit=3, k_limit=4))]:
        np.testing.assert_array_equal(np.asarray(rfa.tile_mask(*args, **kw)),
                                      tile_mask(*args, **kw).numpy())


def test_shapes_are_checked():
    q = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(2, 5, 4), torch.zeros(2, 5, 8))
    before = dict(tops.launches)
    flash_attention(q, q, q)
    assert tops.launches == before                 # the CPU twin is no launch


@pytest.mark.parametrize("dtype,d,dv,want", [
    (torch.bfloat16, 64, 64, "flash_attention_wgmma"),
    (torch.bfloat16, 32, 32, "flash_attention_wgmma"),
    (torch.bfloat16, 128, 128, "flash_attention_wgmma"),
    (torch.bfloat16, 16, 112, "flash_attention_wgmma"),
    (torch.bfloat16, 64, 128, "flash_attention_wgmma"),
    (torch.bfloat16, 40, 40, "flash_attention"),      # D not a multiple of 16
    (torch.bfloat16, 64, 24, "flash_attention"),      # Dv not one either
    (torch.bfloat16, 144, 64, "flash_attention"),     # past 128: refused
    (torch.float32, 64, 64, "flash_attention_wgmma_f32"),   # exact planes
    (torch.float32, 128, 32, "flash_attention_wgmma_f32"),
    (torch.float32, 16, 112, "flash_attention_wgmma_f32"),
    (torch.float32, 40, 40, "flash_attention"),       # D not a multiple of 16
    (torch.float32, 64, 24, "flash_attention"),       # Dv not one either
    (torch.float32, 144, 64, "flash_attention"),      # past 128: refused
])
def test_route_by_dtype_and_head_dims(dtype, d, dv, want):
    q = torch.zeros(2, 5, d, dtype=dtype)
    v = torch.zeros(2, 7, dv, dtype=dtype)
    assert route(q, torch.zeros(2, 7, d, dtype=dtype), v) == want
    assert want in tops.launches


def _split3(x):
    """Exact bf16 planes of f32 x, largest first: hi + mid + lo == x."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, r - mid


def _six(a, b):
    """sum_{i + j <= 2} a_i @ b_j as the f32 route issues it: hi.hi, and
    the five smaller products summed smallest first, then added."""
    pairs = sorted(((i, j) for i in range(3) for j in range(3) if i + j <= 2),
                   key=lambda ij: -(ij[0] + ij[1]))
    small = sum(a[i] @ b[j] for i, j in pairs[:-1])
    return a[0] @ b[0] + small


def _emulate_wgmma_f32(q, k, v, causal):
    """csrc/flash_attention_wgmma.cu's f32 route in torch ops: 64-key
    tiles, scores and P V as six plane products, the softmax in base 2
    of the log2-scaled score, acc = acc * corr + P V."""
    _, lq, d = q.shape
    lk = k.shape[1]
    scale_log2 = np.float32(d ** -0.5 * np.log2(np.e))
    qp = _split3(q)
    m = torch.full((q.shape[0], lq, 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros((q.shape[0], lq, v.shape[2]))
    for k0 in range(0, lk, 64):
        kt, vt = k[:, k0:k0 + 64], v[:, k0:k0 + 64]
        s = _six(qp, _split3(kt.transpose(1, 2))) * scale_log2
        if causal:
            mask = (torch.arange(lq)[:, None]
                    >= k0 + torch.arange(kt.shape[1])[None, :])
            s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + _six(_split3(p), _split3(vt))
        m = m_new
    return o / torch.clamp_min(l, 1e-30)


@pytest.mark.parametrize("lq,lk,d,qb,kb,causal", CASES)
def test_f32_tensor_core_emulation_matches_reference(lq, lk, d, qb, kb,
                                                      causal):
    j, t = _qkv(lq, lk, d, "float32")
    assert route(*t) == "flash_attention_wgmma_f32"
    want = rfa.flash_attention_pallas(*j, causal=causal, q_block=qb,
                                      kv_block=kb, interpret=True)
    got = _emulate_wgmma_f32(*t, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("case", ["cpu", "shape", "rank", "empty"])
def test_cuda_wrapper_refuses(case):
    """What ``flash_attention_cuda`` raises before it touches a card."""
    q = torch.zeros(2, 5, 64, dtype=torch.bfloat16)
    args = {"cpu": (q, q, q),
            "shape": (q, torch.zeros(2, 6, 32, dtype=torch.bfloat16), q),
            "rank": (q[0], q[0], q[0]),
            "empty": (q[:, :0], q, q)}[case]
    before = dict(tops.launches)
    with pytest.raises(ValueError):
        flash_attention_cuda(*args)
    assert tops.launches == before


def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    cases = [(130, 257, 64, False), (3, 7, 64, True), (482, 482, 64, True),
             (100, 40, 32, True), (256, 256, 128, False)]
    for lq, lk, d, causal in cases:
        for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
            _, t = _qkv(lq, lk, d, dt, seed=2)
            q, k, v = (x.cuda() for x in t)
            name = route(q, k, v)
            before = tops.launches[name]
            got = flash_attention_cuda(q, k, v, causal=causal)
            assert tops.launches[name] == before + 1
            want = flash_attention_plain(q, k, v, causal=causal)
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)


TENSOR_CORE_CASES = [
    (1, 257, 64, 64, False), (1, 1, 64, 64, True), (257, 1, 64, 64, True),
    (40, 100, 32, 32, True), (200, 300, 64, 128, True),
    (200, 300, 128, 32, False), (482, 482, 64, 64, False)]


@pytest.mark.parametrize("lq,lk,d,dv,causal", TENSOR_CORE_CASES)
def test_cuda_tensor_core_route_matches_plain(lq, lk, d, dv, causal):
    """The tensor-core route on one-row and one-key calls, Dv != D and
    both head-dim panels, at the bf16 tolerance (2e-2 abs + rel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16).cuda()
               for s in ((4, lq, d), (4, lk, d), (4, lk, dv)))
    assert route(q, k, v) == "flash_attention_wgmma"
    before = tops.launches["flash_attention_wgmma"]
    got = flash_attention_cuda(q, k, v, causal=causal)
    assert tops.launches["flash_attention_wgmma"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == (4, lq, dv) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("lq,lk,d,dv,causal", TENSOR_CORE_CASES + [
    (256, 256, 128, 128, True), (130, 257, 16, 112, True)])
def test_cuda_f32_tensor_core_route_matches_plain(lq, lk, d, dv, causal):
    """The f32 tensor-core route (exact planes) on the same grid, at the
    f32 tolerance (2e-5 abs + rel); a head dim of 40 stays on the CUDA
    cores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda() for s in ((4, lq, d), (4, lk, d), (4, lk, dv)))
    assert route(q, k, v) == "flash_attention_wgmma_f32"
    before = tops.launches["flash_attention_wgmma_f32"]
    got = flash_attention_cuda(q, k, v, causal=causal)
    assert tops.launches["flash_attention_wgmma_f32"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == (4, lq, dv) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    odd = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           .cuda() for s in ((4, lq, 40), (4, lk, 40), (4, lk, 40))]
    assert route(*odd) == "flash_attention"
    before = tops.launches["flash_attention"]
    got = flash_attention_cuda(*odd, causal=causal)
    assert tops.launches["flash_attention"] == before + 1
    torch.testing.assert_close(got, flash_attention_plain(*odd,
                                                          causal=causal),
                               atol=2e-5, rtol=2e-5)
