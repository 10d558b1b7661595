"""The serving LM head (``repro_torch.kernels.serving_head``): the plain
twin against the reference's f32 head product (``common.dense`` with
``compute_dtype=float32``, what ``repro.models.lm._serving_logits``
computes) at M in {1, 8, 40}, both weight layouts (``lm_head`` [d, V]
and the tied embedding [V, d]), the shape checks, and on the card the
kernel: rows bitwise across M and batch places, and within 1e-5 x
sum_k |h_k W_kv| of the f64 product (not of the reference's: where JAX
has a GPU backend its f32 product defaults to TF32).

Tolerance of the twin: both sides sum K = 64 f32 products in their own
order, a few f32 ulps of sum_k |h_k W_kv|: held at 1e-6 of that scale.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common  # noqa: E402
from repro_torch.kernels import serving_head as sh  # noqa: E402

D, V = 64, 256
TWIN_TOL = 1e-6
KERNEL_TOL = 1e-5


def _case(m, seed=0, d=D, v=V):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((m, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    return h, w


def _scaled_err(got, h, w):
    # full f32 wherever JAX runs (its GPU backend defaults to TF32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(common.dense(jnp.asarray(h), jnp.asarray(w),
                                       compute_dtype=jnp.float32))
    scale = np.abs(h.astype(np.float64)) @ np.abs(w.astype(np.float64))
    return float((np.abs(np.asarray(got, np.float64) - want)
                  / scale).max())


@pytest.mark.parametrize("m", [1, 8, 40])
def test_plain_head_matches_reference_product(m):
    h, w = _case(m)
    got = sh.serving_head(torch.from_numpy(h), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (m, V)
    assert _scaled_err(got.numpy(), h, w) <= TWIN_TOL


@pytest.mark.parametrize("m", [1, 8, 40])
def test_plain_head_tied_layout(m):
    """The tied embedding [V, d] read in place gives the [d, V] head's
    logits on the same weights (the CPU GEMM may sum the transposed
    operand in another order: within the twin's tolerance); leading axes
    pass through."""
    h, w = _case(m, seed=1)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    tied = sh.serving_head(th, tw.T.contiguous(), tied=True)
    assert tied.shape == (m, V)
    assert _scaled_err(tied.numpy(), h, w) <= TWIN_TOL
    h3 = th.reshape(1, m, D)
    assert torch.equal(sh.serving_head(h3, tw)[0], sh.serving_head(th, tw))


def test_bf16_hidden_is_widened():
    h, w = _case(8, seed=2)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    got = sh.serving_head(hb, torch.from_numpy(w))
    assert torch.equal(got, sh.serving_head(hb.float(), torch.from_numpy(w)))


def test_shape_mismatch_raises():
    h, w = _case(4)
    with pytest.raises(ValueError, match="does not match"):
        sh.serving_head(torch.from_numpy(h), torch.from_numpy(w).T)
    with pytest.raises(ValueError, match="does not match"):
        sh.serving_head(torch.from_numpy(h), torch.from_numpy(w), tied=True)


def test_bytes_moved():
    assert sh.bytes_moved(8, 1024, 151936, h_bytes=2) == \
        4 * 1024 * 151936 + 2 * 8 * 1024 + 4 * 8 * 151936


def test_kernel_on_card_rows_do_not_depend_on_m():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = _case(64, seed=3, d=1024, v=5000)
    th, tw = torch.from_numpy(h).to(dev), torch.from_numpy(w).to(dev)
    for tied in (False, True):
        ww = tw.T.contiguous() if tied else tw
        full = sh.serving_head_cuda(th, ww, tied=tied)
        for m in (1, 8, 40, 64):
            assert torch.equal(sh.serving_head_cuda(th[:m], ww, tied=tied),
                               full[:m])
        assert torch.equal(sh.serving_head_cuda(th[24:], ww, tied=tied),
                           full[24:])
        h64, w64 = h.astype(np.float64), w.astype(np.float64)
        err = np.abs(full.cpu().numpy() - h64 @ w64) / (np.abs(h64)
                                                        @ np.abs(w64))
        assert float(err.max()) <= KERNEL_TOL
    with pytest.raises(ValueError):
        sh.serving_head_cuda(th, tw.to(torch.bfloat16))
