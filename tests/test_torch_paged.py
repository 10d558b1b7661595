"""Port parity: the paged-KV layout moves of ``repro_torch.models.paged``
are bitwise the reference's (the port updates pools in place; the
reference returns new arrays)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import paged as rp  # noqa: E402
from repro_torch.models import paged as tp  # noqa: E402


def _rows(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_layout_geometry():
    for ctx, bs in ((64, 16), (100, 16), (37, 8)):
        r, t = rp.PagedLayout.for_context(ctx, bs), \
            tp.PagedLayout.for_context(ctx, bs)
        assert tuple(r) == tuple(t) and r.max_context == t.max_context
        assert [r.blocks_for(n) for n in range(0, 130, 7)] == \
            [t.blocks_for(n) for n in range(0, 130, 7)]
        assert rp.default_num_blocks(r, 3) == tp.default_num_blocks(t, 3)


def test_pool_from_rows_gather_identity_bitwise():
    layout = (8, 5)
    rows = _rows(0, (3, 37, 2, 4))
    want_pool = rp.pool_from_rows(jnp.asarray(rows), rp.PagedLayout(*layout))
    pool = tp.pool_from_rows(torch.from_numpy(rows), tp.PagedLayout(*layout))
    np.testing.assert_array_equal(np.asarray(want_pool), pool.numpy())
    want_t = rp.identity_table(3, rp.PagedLayout(*layout))
    table = tp.identity_table(3, tp.PagedLayout(*layout))
    np.testing.assert_array_equal(np.asarray(want_t), table.numpy())
    back = tp.gather_blocks(pool, table)
    np.testing.assert_array_equal(
        np.asarray(rp.gather_blocks(want_pool, want_t)), back.numpy())
    assert np.array_equal(back.numpy()[:, :37], rows)


def test_scatter_token_in_place_bitwise():
    bs, mb, b = 4, 3, 3
    pool0 = _rows(1, (1 + b * mb, bs, 2))
    table = np.array(rp.identity_table(b, rp.PagedLayout(bs, mb)))
    table[2] = 0                       # an idle slot: all-null table
    lens = np.array([5, 2, 40], np.int32)   # the idle slot's len drifted
    vals = _rows(2, (b, 2))
    want = rp.scatter_token(jnp.asarray(pool0), jnp.asarray(table),
                            jnp.asarray(lens), jnp.asarray(vals))
    pool = torch.from_numpy(pool0.copy())
    out = tp.scatter_token(pool, torch.from_numpy(table),
                           torch.from_numpy(lens), torch.from_numpy(vals))
    assert out is pool                 # in place
    np.testing.assert_array_equal(np.asarray(want), pool.numpy())


@pytest.mark.parametrize("pos0", [0, 3, 6])
def test_scatter_chunk_in_place_bitwise(pos0):
    bs, mb = 4, 3
    pool0 = _rows(3, (7, bs, 2))
    row = np.array([4, 2, 6], np.int32)
    vals = _rows(4, (5, 2))
    want = rp.scatter_chunk(jnp.asarray(pool0), jnp.asarray(row),
                            jnp.int32(pos0), jnp.asarray(vals))
    pool = torch.from_numpy(pool0.copy())
    tp.scatter_chunk(pool, torch.from_numpy(row), pos0,
                     torch.from_numpy(vals))
    np.testing.assert_array_equal(np.asarray(want), pool.numpy())


def _caches(l=2, b=3, mb=4, nb=9):
    return {"kpool": torch.from_numpy(_rows(5, (l, nb, 4, 2, 3))),
            "vpool": torch.from_numpy(_rows(6, (l, nb, 4, 2, 3))),
            "block_table": torch.zeros((l, b, mb), dtype=torch.int32),
            "len": torch.tensor([[3, 4, 5]] * l, dtype=torch.int32)}


def _ref_tree(c):
    return {k: jnp.asarray(v.numpy()) for k, v in c.items()}


def test_reset_slot_and_set_lens_bitwise():
    c = _caches()
    row = torch.tensor([2, 5, 0, 0], dtype=torch.int32)
    want = rp.reset_slot(_ref_tree(c), jnp.int32(1), jnp.asarray(row.numpy()))
    tp.reset_slot(c, 1, row)
    for k in c:
        np.testing.assert_array_equal(np.asarray(want[k]), c[k].numpy())
    want = rp.set_lens(want, jnp.asarray([0, 2], jnp.int32),
                       jnp.asarray([7, 9], jnp.int32))
    tp.set_lens(c, torch.tensor([0, 2]), torch.tensor([7, 9]))
    for k in c:
        np.testing.assert_array_equal(np.asarray(want[k]), c[k].numpy())


def test_keep_slots_restores_len_only():
    """With in-place pools the reference's keep_slots reduces to putting
    back the protected slots' lengths; pools keep the new writes."""
    old = _caches()
    new = {k: v.clone() for k, v in old.items()}
    new["len"] += 1
    new["kpool"][:, 3] += 1.0
    keep = np.array([False, True, False])
    want = rp.keep_slots(_ref_tree(old), _ref_tree(new), jnp.asarray(keep))
    tp.keep_slots(new, old["len"].clone(), torch.from_numpy(keep))
    for k in new:
        np.testing.assert_array_equal(np.asarray(want[k]), new[k].numpy())


def test_zero_blocks_bitwise():
    c = _caches()
    want = rp.zero_blocks(_ref_tree(c), [2, 7])
    tp.zero_blocks(c, [2, 7])
    for k in c:
        np.testing.assert_array_equal(np.asarray(want[k]), c[k].numpy())


# ------------------------------------------------ MLA latent pools --------

def _latent_caches(l=2, b=3, mb=4, nb=9, bs=4):
    """A stacked MLA cache tree: latent pools [L, nb, bs, C] and per-token
    scale pools [L, nb, bs] have no head axis."""
    return {"c_kv": torch.from_numpy(_rows(7, (l, nb, bs, 6))),
            "k_rope": torch.from_numpy(_rows(8, (l, nb, bs, 2))),
            "c_kv_scale": torch.from_numpy(_rows(9, (l, nb, bs))),
            "k_rope_scale": torch.from_numpy(_rows(10, (l, nb, bs))),
            "block_table": torch.zeros((l, b, mb), dtype=torch.int32),
            "len": torch.tensor([[3, 4, 5]] * l, dtype=torch.int32)}


def test_pool_keys_are_the_references():
    assert tp.POOL_KEYS == rp.POOL_KEYS


def test_latent_pool_tree_moves_bitwise():
    """reset_slot / set_lens / keep_slots / zero_blocks over 3-D latent
    and 2-D scale pools: pools are never indexed by batch, per-slot leaves
    are, exactly as in the reference."""
    c = _latent_caches()
    row = torch.tensor([2, 5, 0, 0], dtype=torch.int32)
    want = rp.reset_slot(_ref_tree(c), jnp.int32(2), jnp.asarray(row.numpy()))
    tp.reset_slot(c, 2, row)
    want = rp.set_lens(want, jnp.asarray([1], jnp.int32),
                       jnp.asarray([6], jnp.int32))
    tp.set_lens(c, torch.tensor([1]), torch.tensor([6]))
    for k in c:
        np.testing.assert_array_equal(np.asarray(want[k]), c[k].numpy())
    new = {k: v.clone() for k, v in c.items()}
    new["len"] += 1
    new["c_kv"][:, 5] += 1.0
    new["k_rope_scale"][:, 2] += 1.0
    keep = np.array([True, False, True])
    want = rp.keep_slots(_ref_tree(c), _ref_tree(new), jnp.asarray(keep))
    tp.keep_slots(new, c["len"].clone(), torch.from_numpy(keep))
    for k in new:
        np.testing.assert_array_equal(np.asarray(want[k]), new[k].numpy())
    want = rp.zero_blocks(want, [2, 5])
    tp.zero_blocks(new, [2, 5])
    for k in new:
        np.testing.assert_array_equal(np.asarray(want[k]), new[k].numpy())


@pytest.mark.parametrize("name", ["c_kv", "c_kv_scale"])
def test_gather_and_scatter_latent_pools_bitwise(name):
    pool0 = _latent_caches()[name][0].numpy()        # [nb, bs(, C)]
    table = np.array([[3, 1, 0, 0], [8, 2, 6, 0]], np.int32)
    np.testing.assert_array_equal(
        np.asarray(rp.gather_blocks(jnp.asarray(pool0), jnp.asarray(table))),
        tp.gather_blocks(torch.from_numpy(pool0),
                         torch.from_numpy(table)).numpy())
    lens = np.array([5, 9], np.int32)
    vals = _rows(11, (2,) + pool0.shape[2:])
    want = rp.scatter_token(jnp.asarray(pool0), jnp.asarray(table),
                            jnp.asarray(lens), jnp.asarray(vals))
    pool = torch.from_numpy(pool0.copy())
    tp.scatter_token(pool, torch.from_numpy(table), torch.from_numpy(lens),
                     torch.from_numpy(vals))
    np.testing.assert_array_equal(np.asarray(want), pool.numpy())
    chunk = _rows(12, (6,) + pool0.shape[2:])
    want = rp.scatter_chunk(jnp.asarray(pool0), jnp.asarray(table[1]),
                            jnp.int32(3), jnp.asarray(chunk))
    pool = torch.from_numpy(pool0.copy())
    tp.scatter_chunk(pool, torch.from_numpy(table[1]), 3,
                     torch.from_numpy(chunk))
    np.testing.assert_array_equal(np.asarray(want), pool.numpy())
