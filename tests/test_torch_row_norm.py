"""The row norms (``repro_torch.kernels.row_norm``, dispatched by
``models.common.rms_norm`` / ``layer_norm``): the plain twins against the
reference's ``repro.models.common`` norms on the same seeded rows, the
CPU dispatch (the twin, no launch), the wrapper's checks, and on the card
the kernel: every row bitwise the same at any M and batch place, within
``chip_smoke.NORM_TOL`` of the twin, and one launch per call under
no_grad, none under autograd.

Tolerance against the reference: both sides sum d f32 terms in their own
order (XLA's reduction against torch's), so an f32 output differs by a
few ulps of the element's scale, held at 1e-6 of it; a bf16 output by
at most the one bf16 step (2^-7 of the scale) that such a difference can
cross. The scale: |x_hat w| for the RMS norm, (|x - mu| + mean|x|) r |w|
+ |b| for the layer norm (the mean's rounding moves every x - mu).
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common as rcommon  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import row_norm as rn  # noqa: E402
from repro_torch.models import common  # noqa: E402

TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}


def _case(m, d, seed=0):
    """Rows of scales 0.01-100 with an offset mean, weights about 1 and
    biases about 0.1 (f32 numpy)."""
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.uniform(np.log(0.01), np.log(100.0), (m, 1)))
    x = (rng.standard_normal((m, d)) * scale
         + 0.5 * scale * rng.standard_normal((m, 1))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, w, b


def _scale(x, w, b, layer, eps):
    x = x.astype(np.float64)
    if not layer:
        r = 1 / np.sqrt(np.mean(x * x, -1, keepdims=True) + eps)
        return np.abs(x * r * w)
    c = x - x.mean(-1, keepdims=True)
    r = 1 / np.sqrt(np.mean(c * c, -1, keepdims=True) + eps)
    return (np.abs(c) + np.abs(x).mean(-1, keepdims=True)) * r * np.abs(w) \
        + np.abs(b)


@pytest.mark.parametrize("layer", [False, True], ids=["rms", "layer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 384])
def test_twin_matches_reference(layer, dtype, d):
    x, w, b = _case(16, d, seed=d)
    tx = torch.from_numpy(x).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(tx.float().numpy(), dtype=jdt)
    eps = 1e-5 if layer else 1e-6
    if layer:
        got = common.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b))
        want = rcommon.layer_norm(jx, jnp.asarray(w), jnp.asarray(b))
    else:
        got = common.rms_norm(tx, torch.from_numpy(w))
        want = rcommon.rms_norm(jx, jnp.asarray(w))
    assert got.dtype == dtype and got.shape == (16, d)
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)) \
        / _scale(tx.float().numpy(), w, b, layer, eps)
    assert float(err.max()) <= TOL[dtype]


def test_cpu_dispatch_is_the_twin():
    """On the CPU both entry points are the plain twins, bitwise, with
    and without autograd, and launch nothing."""
    x, w, b = _case(8, 96, seed=1)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    _build.reset_launches()
    with torch.no_grad():
        assert torch.equal(common.rms_norm(tx, tw),
                           rn.rms_norm_plain(tx, tw))
        assert torch.equal(common.layer_norm(tx, tw, tb),
                           rn.layer_norm_plain(tx, tw, tb))
    twg = tw.clone().requires_grad_(True)
    y = common.rms_norm(tx, twg)
    y.sum().backward()
    assert twg.grad is not None
    assert _build.launches["row_norm"] == 0


def test_wrapper_checks():
    x, w, b = _case(4, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rn.row_norm_cuda(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6)
    assert rn.bytes_moved(8, 1024) == 2 * 8 * 1024 * 2 + 4 * 1024
    assert rn.bytes_moved(8, 1024, 4, layer=True) == \
        2 * 8 * 1024 * 4 + 8 * 1024


def test_kernel_on_card_rows_do_not_depend_on_m():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    for d in (64, 384, 1000, 5120):
        x, w, b = _case(256, d, seed=d)
        tx = torch.from_numpy(x).to(dev)
        tw, tb = torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd = tx.to(dtype)
            for bias, eps in ((None, 1e-6), (tb, 1e-5)):
                full = rn.row_norm_cuda(xd, tw, bias, eps=eps)
                for m in (1, 8, 40, 64, 240):
                    assert torch.equal(
                        rn.row_norm_cuda(xd[:m], tw, bias, eps=eps),
                        full[:m])
                assert torch.equal(
                    rn.row_norm_cuda(xd[17:57], tw, bias, eps=eps),
                    full[17:57])
                plain = (rn.rms_norm_plain(xd, tw, eps=eps) if bias is None
                         else rn.layer_norm_plain(xd, tw, bias, eps=eps))
                err = np.abs(full.float().cpu().numpy()
                             - plain.float().cpu().numpy()) / _scale(
                    xd.float().cpu().numpy(), w, b, bias is not None, eps)
                assert float(err.max()) <= \
                    (1e-5 if dtype == torch.float32 else 2.0 ** -7)
    _build.reset_launches()
    with torch.no_grad():
        common.rms_norm(tx[:8], tw)
    y = common.rms_norm(tx[:8], tw.clone().requires_grad_(True))
    assert y.requires_grad and _build.launches["row_norm"] == 1


def test_kernel_on_card_routes_give_the_same_bits():
    """Every route and rows per CTA the kernel's C entry
    ``repro_row_norm_ex`` takes at a width (the limits ``plan`` reads
    from the library) gives the bits of ``row_norm_cuda``, the route
    ``plan`` picks (one sum order, set by d); a count past a route's
    limit is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "norm_parent_bits", os.path.join(os.path.dirname(__file__), "..",
                                         "tools", "norm_parent_bits.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    dev = torch.device("cuda")
    for d in (64, 384, 1000, 1024, 2048, 5120):
        x, w, b = _case(67, d, seed=d + 1)
        tx = torch.from_numpy(x).to(dev)
        tw, tb = torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)
        forms = tool.variants(d)[1:]
        limits = rn.plan(d)["max_rows"]
        assert limits["wide"] <= 15 and (d > 1024 or limits["narrow"] == 8)
        for dtype in (torch.float32, torch.bfloat16):
            xd = tx.to(dtype)
            for bias, eps in ((None, 1e-6), (tb, 1e-5)):
                want = rn.row_norm_cuda(xd, tw, bias, eps=eps)
                for form in forms:
                    assert torch.equal(
                        tool.forced_norm(xd, tw, bias, eps, **form),
                        want), (d, dtype, bias is None, form)
        for route, most in limits.items():
            with pytest.raises(RuntimeError):
                tool.forced_norm(tx, tw, tb, 1e-5, route=route,
                                 rows=most + 1)
