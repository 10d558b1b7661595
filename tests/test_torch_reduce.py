"""Port parity: the compensated row-reduction engine.

The plain twin (``fused_reduce_rows_plain`` / ``_flat_plain``) mirrors
the reference's stream layout — ``pick_block_elems`` blocks, U x (8, 128)
Neumaier streams, TwoSum fold over streams, sublanes, lanes — so its
compensated outputs and maxima are held BITWISE to
``repro.kernels.ops.batched_fused_reduce`` / ``fused_reduce`` in
interpret mode. The naive (``compensated=False``) baseline sums each
block's (8, 128) partials in an order XLA chooses, so it is held at the
naive-summation bound instead. The CUDA kernel is compared with the
plain twin on the card (skipped without a GPU).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import engine as re  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import engine as te  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

F32_EPS = float(np.finfo(np.float32).eps)
OUTPUT_SETS = [("max", "sum", "sumsq"), ("sum",), ("dot", "maxabs"),
               ("sumsq", "dot", "max"), ("maxabs",)]
SHAPES = [(3, 100), (2, 5000), (4, 33000), (1, 1), (2, 1025)]


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * 2.0 ** rng.integers(-8, 8, shape)).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    return x, y


def _ref(x, y, outputs, compensated=True):
    if compensated:
        out = rops.batched_fused_reduce(jnp.asarray(x), jnp.asarray(y),
                                        outputs=outputs, interpret=True)
        return {k: np.asarray(v) for k, v in out.items()}
    ops = ((jnp.asarray(x), jnp.asarray(y)) if "dot" in outputs
           else (jnp.asarray(x),))
    outs = re.fused_reduce_rows(ops, outputs=outputs, compensated=False,
                                interpret=True)
    return {k: np.asarray(v) for k, v in zip(outputs, outs)}


def _port(x, y, outputs, compensated=True):
    ops = ((torch.from_numpy(x), torch.from_numpy(y)) if "dot" in outputs
           else (torch.from_numpy(x),))
    outs = te.fused_reduce_rows_plain(ops, outputs=outputs,
                                      compensated=compensated)
    return {k: v.numpy() for k, v in zip(outputs, outs)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("outputs", OUTPUT_SETS)
def test_rows_compensated_bitwise(outputs, shape):
    x, y = _data(shape, sum(shape) + len(outputs))
    want, got = _ref(x, y, outputs), _port(x, y, outputs)
    for o in outputs:
        np.testing.assert_array_equal(want[o].view(np.uint32),
                                      got[o].view(np.uint32), err_msg=o)


@pytest.mark.parametrize("shape", [(3, 100), (2, 5000), (4, 33000)])
@pytest.mark.parametrize("outputs", [("sum", "max"), ("dot",), ("sumsq",)])
def test_rows_naive_within_summation_bound(outputs, shape):
    """Naive sums: XLA's order inside each block differs from torch's, so
    each side is within gamma_depth * sum|terms| of the exact sum, depth =
    the blocks' partial-sum chains plus the final 1024-term reduce."""
    x, y = _data(shape, 3 * shape[1])
    want, got = _ref(x, y, outputs, False), _port(x, y, outputs, False)
    terms = {"sum": np.abs(x), "dot": np.abs(x * y), "sumsq": x * x}
    depth = shape[1] / 1024 + 1024
    for o in outputs:
        if o == "max":
            np.testing.assert_array_equal(want[o], got[o])
            continue
        bound = depth * F32_EPS * terms[o].astype(np.float64).sum(axis=1)
        assert np.all(np.abs(want[o].astype(np.float64) - got[o]) <= bound)


def test_rows_nonfinite_semantics():
    """A compensated sum over +-inf is NaN (TwoSum inf - inf), max
    propagates NaN, maxabs sees |inf| — as in the reference."""
    x, y = _data((4, 3000), 11)
    x[1, 17] = np.inf
    x[2, 2999] = np.nan
    x[3, 5] = -np.inf
    outputs = ("sum", "max", "maxabs", "dot")
    want, got = _ref(x, y, outputs), _port(x, y, outputs)
    for o in outputs:
        np.testing.assert_array_equal(want[o].view(np.uint32),
                                      got[o].view(np.uint32), err_msg=o)
    assert np.isnan(got["sum"][1]) and np.isnan(got["max"][2])
    assert got["maxabs"][3] == np.inf and np.isfinite(got["sum"][0])


@pytest.mark.parametrize("n", [1, 1000, 70000])
def test_flat_and_scalar_ops_bitwise(n):
    x, y = _data((n,), n)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = rops.fused_reduce(jnp.asarray(x), jnp.asarray(y),
                             outputs=("dot", "sum", "sumsq", "maxabs"),
                             interpret=True)
    got = tops.fused_reduce(tx, ty, outputs=("dot", "sum", "sumsq",
                                             "maxabs"))
    for k in want:
        assert np.asarray(want[k]).view(np.uint32) == \
            got[k].numpy().view(np.uint32), k
    (flat,) = te.fused_reduce_flat_plain((tx, ty), outputs=("dot",))
    assert flat.shape == () and flat.item() == got["dot"].item()
    assert tops.kahan_dot(tx, ty).item() == float(
        rops.kahan_dot(jnp.asarray(x), jnp.asarray(y), interpret=True))
    assert tops.kahan_sum(tx).item() == float(
        rops.kahan_sum(jnp.asarray(x), interpret=True))
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    bound = (n + 1) * F32_EPS * float(np.abs(x * y).astype(np.float64).sum())
    assert abs(tops.naive_dot(tx, ty).item() - exact) <= bound


def test_block_schedule_matches_reference():
    for n in (1, 100, 4097, 151936, 10_000_000):
        for u in (1, 2, 4, 8):
            assert te.pick_block_elems(n, u) == re.pick_block_elems(n, u)
    assert te.default_unroll(("max", "sumsq")) == \
        re.default_unroll(("max", "sumsq"))


def test_dispatch_checks():
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError):
        tops.batched_fused_reduce(x, outputs=("dot",))
    with pytest.raises(ValueError):
        tops.batched_fused_reduce(x, outputs=("median",))
    with pytest.raises(ValueError):
        tops.batched_fused_reduce(x.reshape(-1), outputs=("sum",))
    before = dict(tops.launches)
    tops.batched_fused_reduce(x, outputs=("sum",))
    assert tops.launches == before       # the CPU twin is not a launch


def test_splits_cover_rows():
    for b, n in ((8, 151936), (1, 1 << 24), (3, 5), (64, 4096)):
        s, seg = te.splits(b, n)
        assert seg % 4 == 0 and s * seg >= n and (s - 1) * seg < n


@pytest.mark.parametrize("compensated", [True, False])
def test_cuda_kernel_matches_plain(compensated):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x, y = _data((5, 33000), 21)
    tx, ty = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    outputs = ("dot", "sum", "sumsq", "max", "maxabs")
    before = tops.launches["fused_reduce"]
    got = te.fused_reduce_rows_cuda((tx, ty), outputs=outputs,
                                    compensated=compensated)
    assert tops.launches["fused_reduce"] == before + 1   # counted per call
    want = te.fused_reduce_rows_plain((tx, ty), outputs=outputs,
                                      compensated=compensated)
    terms = {"dot": np.abs(x * y), "sum": np.abs(x), "sumsq": x * x}
    for o, g, w in zip(outputs, got, want):
        if o in ("max", "maxabs"):
            assert torch.equal(g, w)
            continue
        # compensated: both within ~2 ulp of the exact sum; naive: the
        # summation-depth bound of either order
        s = terms[o].astype(np.float64).sum(axis=1)
        tol = (4 * F32_EPS * np.abs(w.cpu().numpy()) + 16 * F32_EPS ** 2 * s
               if compensated else 2100 * F32_EPS * s)
        assert np.all(np.abs((g - w).double().cpu().numpy()) <= tol), o
