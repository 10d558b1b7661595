"""Port parity: the compensated-summation primitives of
``repro_torch.core.kahan`` are bitwise the reference's (pure f32 adds in
the same order, no contraction on either side)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kahan as rk  # noqa: E402
from repro_torch.core import kahan as tk  # noqa: E402


def _mixed(shape, seed, span=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * 2.0 ** rng.integers(-span, span, shape)).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fn", ["twosum", "kahan_step", "neumaier_step",
                                "combine"])
def test_primitives_bitwise(fn, seed):
    args = [_mixed((257,), seed * 10 + i) for i in range(4)]
    n_args = 4 if fn == "combine" else (2 if fn == "twosum" else 3)
    args = args[:n_args]
    want = jax.jit(getattr(rk, fn))(*map(jnp.asarray, args))
    got = getattr(tk, fn)(*map(torch.from_numpy, args))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bits(w), _bits(g.numpy()))


def test_twosum_is_exact():
    a, b = _mixed((1000,), 7), _mixed((1000,), 8)
    s, e = tk.twosum(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        s.double().numpy() + e.double().numpy(),
        a.astype(np.float64) + b.astype(np.float64))


def test_nonfinite_twosum_is_nan_like_reference():
    a = np.array([np.inf, -np.inf, 1.0, np.nan], np.float32)
    b = np.array([1.0, 2.0, np.inf, 1.0], np.float32)
    want = jax.jit(rk.twosum)(jnp.asarray(a), jnp.asarray(b))
    got = tk.twosum(torch.from_numpy(a), torch.from_numpy(b))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.isnan(np.asarray(w)),
                                      np.isnan(g.numpy()))


@pytest.mark.parametrize("variant", ["neumaier", "kahan"])
def test_scan_sum_and_dot_bitwise(variant):
    x, y = _mixed((300,), 1), _mixed((300,), 2)
    want = jax.jit(lambda v: rk.kahan_sum(v, axis=0, variant=variant))(
        jnp.asarray(x))
    got = tk.kahan_sum(torch.from_numpy(x), axis=0, variant=variant)
    assert _bits(want) == _bits(got.numpy())
    want = jax.jit(lambda a, b: rk.kahan_dot(a, b, variant=variant))(
        jnp.asarray(x), jnp.asarray(y))
    got = tk.kahan_dot(torch.from_numpy(x), torch.from_numpy(y),
                       variant=variant)
    assert _bits(want) == _bits(got.numpy())


def test_scan_sum_along_axis():
    x = _mixed((40, 3, 5), 4)
    want = jax.jit(lambda v: rk.kahan_sum(v, axis=1))(jnp.asarray(x))
    got = tk.kahan_sum(torch.from_numpy(x), axis=1)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    assert tk.value(torch.tensor(1.0), torch.tensor(2.0 ** -30)) == 1.0
