"""Port parity: the paged-KV layout moves of ``repro_torch.models.paged``
are bitwise the reference's (the port updates pools in place; the
reference returns new arrays)."""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

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
    keep_t = torch.from_numpy(keep)
    tp.keep_slots(new, tp.save_slots(old, keep_t), keep_t)
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
    keep_t = torch.from_numpy(keep)
    tp.keep_slots(new, tp.save_slots(c, keep_t), keep_t)
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


# ------------------------------- block copies and host snapshots ----------

def test_layout_helpers_match_reference():
    for spec in (100, rp.PagedLayout(8, 5)):
        tspec = spec if isinstance(spec, int) else tp.PagedLayout(*spec)
        assert tuple(rp.as_layout(spec)) == tuple(tp.as_layout(tspec))
    lay = (16, 7)
    for batch, mult in ((3, 4), (8, 8), (1, 3)):
        assert rp.padded_num_blocks(rp.PagedLayout(*lay), batch, mult) == \
            tp.padded_num_blocks(tp.PagedLayout(*lay), batch, mult)


def _bridged_pools(arch, kv_dtype, seed=0):
    """Random reference pools for ``arch`` at ``kv_dtype`` (every pool
    leaf filled: payload bytes, scale tiles, MLA latents) and the port's
    bridged copy."""
    import jax
    from repro.configs import get_config, reduced
    from repro.models import api
    from repro_torch import bridge
    cfg = reduced(get_config(arch)).with_(num_layers=3, kv_dtype=kv_dtype)
    kv = api.KVCache.build(cfg, max_context=64, block_size=16, max_slots=2)
    rng = np.random.default_rng(seed)
    ref = []
    for stack in kv.init(2):
        out = {}
        for k, v in stack.items():
            a = np.asarray(v)
            if k in rp.POOL_KEYS:
                if np.issubdtype(a.dtype, np.integer):
                    info = np.iinfo(a.dtype)
                    a = rng.integers(info.min, info.max + 1,
                                     a.shape).astype(a.dtype)
                else:
                    a = rng.normal(size=a.shape).astype(a.dtype)
            out[k] = a
        ref.append(out)
    port = bridge.caches_from_reference(ref, device="cpu")
    tree = tuple({k: jax.numpy.asarray(v) for k, v in c.items()}
                 for c in ref)
    return tree, port


def _bits(a):
    """Bit pattern of a pool leaf, numpy or torch (bf16 widened)."""
    from repro_torch import bridge
    if isinstance(a, torch.Tensor):
        a = bridge.to_numpy(a)
    a = np.asarray(a)
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    return a.astype(np.float32).view(np.uint32)


def _ref_by_leaf(tree_or_snap, nstacks):
    """The reference's per-stack leaves (a cache tuple, or an
    ``extract_blocks`` dict keyed by path) concatenated over the layer
    axis, as the port stacks them."""
    if isinstance(tree_or_snap, dict):
        names = {k.split("'")[1] for k in tree_or_snap}
        return {n: np.concatenate([np.asarray(tree_or_snap[f"[{i}]['{n}']"])
                                   for i in range(nstacks)])
                for n in names}
    return {n: np.concatenate([np.asarray(t[n]) for t in tree_or_snap])
            for n in tree_or_snap[0] if n in rp.POOL_KEYS}


CASES = [("qwen1.5-0.5b", d) for d in ("bf16", "int8", "fp8")] + \
    [("deepseek-v2-236b", d) for d in ("bf16", "int8", "fp8")]


@pytest.mark.parametrize("arch,kv_dtype", CASES)
def test_copy_block_bitwise(arch, kv_dtype):
    tree, port = _bridged_pools(arch, kv_dtype)
    want = rp.copy_block(tree, jnp.int32(3), jnp.int32(6))
    tp.copy_block(port, 3, 6)
    ref = _ref_by_leaf(want, len(want))
    assert set(ref) == {k for k in port if k in tp.POOL_KEYS}
    for k, v in ref.items():
        np.testing.assert_array_equal(_bits(port[k]), _bits(v), err_msg=k)


@pytest.mark.parametrize("arch,kv_dtype", CASES)
def test_extract_restore_concat_bitwise(arch, kv_dtype):
    """extract_blocks gathers every pool leaf (scale tiles and latents
    included) bitwise the reference's; restore_blocks into other block
    ids and the concatenation of per-block snapshots too."""
    tree, port = _bridged_pools(arch, kv_dtype)
    n = len(tree)
    blocks = [5, 2, 7]
    snap = tp.extract_blocks(port, blocks)
    want = _ref_by_leaf(rp.extract_blocks(tree, blocks), n)
    assert set(snap) == set(want)
    if kv_dtype != "bf16":
        assert any("scale" in k for k in snap)
    for k in want:
        assert snap[k].device.type == "cpu"
        np.testing.assert_array_equal(_bits(snap[k]), _bits(want[k]),
                                      err_msg=k)
    assert tp.snapshot_bytes(snap) == sum(t.nbytes for t in snap.values())
    # per-block snapshots concatenated == the 3-block snapshot
    parts = [tp.extract_blocks(port, [b]) for b in blocks]
    cat = tp.concat_block_snapshots(parts)
    ref_cat = rp.concat_block_snapshots(
        [{k: np.asarray(v) for k, v in rp.extract_blocks(tree, [b]).items()}
         for b in blocks])
    ref_cat = _ref_by_leaf(ref_cat, n)
    for k in want:
        np.testing.assert_array_equal(_bits(cat[k]), _bits(ref_cat[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(_bits(cat[k]), _bits(snap[k]),
                                      err_msg=k)
    # restore into other ids: the pools equal the reference's restore
    others = [1, 8, 4]
    rsnap = rp.extract_blocks(tree, blocks)
    want_tree = rp.restore_blocks(tree, others, rsnap)
    tp.restore_blocks(port, others, snap)
    for k, v in _ref_by_leaf(want_tree, n).items():
        np.testing.assert_array_equal(_bits(port[k]), _bits(v), err_msg=k)
    back = tp.extract_blocks(port, others)
    for k in snap:
        np.testing.assert_array_equal(_bits(back[k]), _bits(snap[k]),
                                      err_msg=k)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_snapshots_on_card_pinned_bitwise(kv_dtype):
    """On the card: snapshots land in pinned host memory, bitwise the CPU
    pool's, and restore into other blocks bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    _, port = _bridged_pools("qwen1.5-0.5b", kv_dtype)
    card = {k: v.cuda() for k, v in port.items()}
    blocks, others = [5, 2, 7], [1, 8, 4]
    snap = tp.extract_blocks(card, blocks)
    want = tp.extract_blocks(port, blocks)
    for k in want:
        assert snap[k].is_pinned() and torch.equal(snap[k], want[k]), k
    cat = tp.concat_block_snapshots([tp.extract_blocks(card, [b])
                                     for b in blocks])
    tp.restore_blocks(card, others, cat)
    tp.copy_block(card, others[0], 3)
    back = tp.extract_blocks(card, others + [3])
    for k in want:
        assert cat[k].is_pinned()
        assert torch.equal(back[k][:, :3], want[k]), k
        assert torch.equal(back[k][:, 3], want[k][:, 0]), k
