"""Keyed randomness of the port: ``repro_torch.core.prng`` against
``jax.random`` (threefry2x32, partitionable bit layout) on the CPU.

Keys, ``fold_in``, ``split``, bits, uniforms and integers are bitwise
jax's over seeded grids of seeds, data, shapes (odd sizes and sizes past
2^16 included) and ranges. Gumbel noise goes through ``log``, which may
differ from XLA's: it is held within ``GUMBEL_EPS`` f32 epsilons of
max(1, |g|) (1.8 measured). ``categorical`` draws are token-equal on the
pinned rows below. The reference runs under
``jax.threefry_partitionable(True)``, so the bits do not hang on the
installed default.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.core import prng  # noqa: E402

GUMBEL_EPS = 4
F32_EPS = float(np.finfo(np.float32).eps)
SEEDS = [0, 1, 3, 7, 123, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 32 - 1,
         2 ** 32 + 9, -1, -12345]
SHAPES = [(), (1,), (2,), (5,), (7, 3), (2, 3, 5), (65537,), (3, 40001)]


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _jkey(seed, *data):
    k = jax.random.key(seed)
    for d in data:
        k = jax.random.fold_in(k, d)
    return k


def _tkey(seed, *data, device="cpu"):
    k = prng.key(seed, device=device)
    for d in data:
        k = prng.fold_in(k, d)
    return k


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_known_answers():
    assert prng.fold_in(prng.key(3, device="cpu"), 5).tolist() == [
        2464363587, 131619366]
    k = _tkey(123, 7)
    assert k.tolist() == [4195957486, 134989543]
    u = prng.uniform(k)
    assert u.dtype == torch.float32
    assert u.view(torch.int32).item() == 1025456736
    assert u.item() == 0.038874030113220215
    assert int(prng.randint(prng.fold_in(k, 1), (), 0, 10)) == 7
    assert int(prng.categorical(k, torch.zeros(151936))) == 14761


def test_key_and_fold_in_match_jax():
    rng = np.random.default_rng(0)
    for seed in SEEDS:
        np.testing.assert_array_equal(prng.key(seed, device="cpu").numpy(),
                                      _kd(jax.random.key(seed)))
        data = [0, 1, 2 ** 32 - 1] + rng.integers(0, 2 ** 32, 5).tolist()
        for d in data:
            np.testing.assert_array_equal(_tkey(seed, d).numpy(),
                                          _kd(_jkey(seed, d)))
        chain = rng.integers(0, 2 ** 20, 6).tolist()
        np.testing.assert_array_equal(_tkey(seed, *chain).numpy(),
                                      _kd(_jkey(seed, *chain)))
    # a batch of keys folds a batch of data (the tensor path) the same way
    keys = torch.stack([_tkey(s) for s in SEEDS])
    data = torch.tensor(rng.integers(0, 2 ** 32, len(SEEDS)))
    got = prng.fold_in(keys, data)
    for i, s in enumerate(SEEDS):
        np.testing.assert_array_equal(got[i].numpy(),
                                      _kd(_jkey(s, int(data[i]))))
    with pytest.raises(ValueError):
        prng.fold_in(prng.key(0, device="cpu"), -1)


def test_split_matches_jax():
    for seed in SEEDS[:6]:
        for num in (1, 2, 3, 8):
            np.testing.assert_array_equal(
                prng.split(_tkey(seed, 11), num).numpy(),
                _kd(jax.random.split(_jkey(seed, 11), num)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_match_jax(shape):
    for seed in (0, 5, 2 ** 31 + 5):
        jk, tk = _jkey(seed, 99), _tkey(seed, 99)
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        got = prng.random_bits(tk, shape)
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                       (-3.0, 2.5), (10.0, 1e4)):
            want = np.asarray(jax.random.uniform(jk, shape, jnp.float32,
                                                 lo, hi))
            got = prng.uniform(tk, shape, lo, hi)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          want.view(np.uint32))


def test_batched_keys_are_vmap():
    seeds = list(range(9))
    jkeys = jnp.stack([_jkey(s, 3) for s in seeds])
    tkeys = torch.stack([_tkey(s, 3) for s in seeds])
    for shape in ((), (5,), (4, 3)):
        want = jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(
            jkeys)
        np.testing.assert_array_equal(prng.random_bits(tkeys, shape).numpy(),
                                      np.asarray(want).astype(np.int64))
        want = jax.vmap(lambda k: jax.random.uniform(k, shape))(jkeys)
        np.testing.assert_array_equal(
            prng.uniform(tkeys, shape).numpy().view(np.uint32),
            np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(0, 10), (0, 1), (-5, 1000), (7, 7),
                                   (9, 3), (0, 2 ** 16 + 3),
                                   (-100, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)])
def test_randint_matches_jax(lo, hi):
    for seed in (0, 3, 2 ** 31 + 5):
        for shape in ((), (7,), (3, 11), (70001,)):
            jk, tk = _jkey(seed, 4, 1), _tkey(seed, 4, 1)
            want = np.asarray(jax.random.randint(jk, shape, lo, hi))
            got = prng.randint(tk, shape, lo, hi)
            np.testing.assert_array_equal(got.numpy(),
                                          want.astype(np.int64))


def test_host_scalar_path_equals_tensor_path():
    """A single CPU key draws scalars on Python ints; a batch of one key
    takes the tensor path: same bits."""
    for seed in range(40):
        k = _tkey(seed, seed * 3 + 1)
        batch = k.reshape(1, 2)
        assert int(prng.random_bits(k)) == int(prng.random_bits(batch)[0])
        for lo, hi in ((0.0, 1.0), (-3.0, 2.5)):
            assert prng.uniform(k, (), lo, hi).view(torch.int32).item() == \
                prng.uniform(batch, (), lo, hi)[0].view(torch.int32).item()
        assert int(prng.randint(k, (), -9, seed + 1)) == \
            int(prng.randint(k, (1,), -9, seed + 1)[0])


def test_gumbel_within_ulp_bound():
    worst = 0.0
    for seed in range(8):
        want = np.asarray(jax.random.gumbel(_jkey(seed, 2), (151936,)),
                          np.float64)
        got = prng.gumbel(_tkey(seed, 2), (151936,)).numpy().astype(
            np.float64)
        err = np.abs(got - want) / (F32_EPS * np.maximum(1.0, np.abs(want)))
        worst = max(worst, float(err.max()))
    assert worst <= GUMBEL_EPS


@pytest.mark.parametrize("vocab", [2, 17, 256, 151936])
def test_categorical_matches_jax_on_pinned_rows(vocab):
    rng = np.random.default_rng(vocab)
    rows = (rng.normal(size=(6, vocab)) * 3).astype(np.float32)
    rows[1] = 0.0                                   # all ties
    rows[2, ::2] = rows[2, 0]                       # a tied half
    rows[3, : vocab // 2] = -np.inf                 # masked half
    jkeys = jnp.stack([_jkey(s, 17) for s in range(6)])
    tkeys = torch.stack([_tkey(s, 17) for s in range(6)])
    want = jax.vmap(jax.random.categorical)(jkeys, jnp.asarray(rows))
    got = prng.categorical(tkeys, torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = prng.categorical(tkeys[0], torch.from_numpy(rows[0]))
    assert int(one) == int(jax.random.categorical(jkeys[0], rows[0]))


def test_key_defaults_to_the_card():
    if torch.cuda.is_available():
        assert prng.key(0).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prng.key(0)


def test_card_draws_equal_cpu_draws():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    keys = torch.stack([_tkey(s, 5) for s in range(16)])
    cuda = keys.cuda()
    for shape in ((), (3,), (100003,)):
        assert torch.equal(prng.random_bits(cuda, shape).cpu(),
                           prng.random_bits(keys, shape))
        assert torch.equal(prng.uniform(cuda, shape).cpu(),
                           prng.uniform(keys, shape))
        assert torch.equal(prng.randint(cuda[0], shape, -3, 1000).cpu(),
                           prng.randint(keys[0], shape, -3, 1000))
    assert torch.equal(prng.fold_in(cuda, 7).cpu(), prng.fold_in(keys, 7))
    assert int(prng.categorical(_tkey(123, 7, device="cuda"),
                                torch.zeros(151936, device="cuda"))) == 14761
