"""Block-paged KV cache layout (twin of ``repro.models.paged``).

  pool         [num_blocks, block_size, ...]   KV data shared by all slots
  block_table  [B, max_blocks] int32           per-slot pool-block indices
  len          [B] int32                       valid tokens per slot

Block 0 is the reserved null block: never allocated, inactive slots'
tables point at it, and stray writes from the batched decode step land
there. Unlike the reference, the port updates pools and per-slot state
IN PLACE (``index_put_`` and slice assignment): the scatter functions
write into the pool they are given and return it; the cache-tree
functions mutate the cache dict's tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

DEFAULT_BLOCK_SIZE = 16
NULL_BLOCK = 0

# leaf names that are shared block pools (no batch axis): GQA K/V pools
# [nb, bs, Hkv, D] with scales [nb, bs, Hkv], and MLA latent pools
# [nb, bs, C] with per-token scales [nb, bs]
POOL_KEYS = ("kpool", "vpool", "c_kv", "k_rope",
             "kscale", "vscale", "c_kv_scale", "k_rope_scale")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PagedLayout(NamedTuple):
    """Per-sequence paging geometry."""

    block_size: int
    max_blocks: int

    @property
    def max_context(self) -> int:
        return self.block_size * self.max_blocks

    def blocks_for(self, num_tokens: int) -> int:
        return min(cdiv(num_tokens, self.block_size), self.max_blocks)

    @staticmethod
    def for_context(max_context: int,
                    block_size: int = DEFAULT_BLOCK_SIZE) -> "PagedLayout":
        return PagedLayout(block_size, cdiv(max_context, block_size))


def as_layout(spec) -> PagedLayout:
    """Accept an int max-context or a ``PagedLayout``."""
    if isinstance(spec, PagedLayout):
        return spec
    return PagedLayout.for_context(int(spec))


def default_num_blocks(layout: PagedLayout, batch: int) -> int:
    """Pool size that holds ``batch`` full-context sequences + null."""
    return 1 + batch * layout.max_blocks


def padded_num_blocks(layout: PagedLayout, batch: int, multiple: int) -> int:
    """``default_num_blocks`` rounded up to a multiple of ``multiple`` (a
    pool whose block axis splits evenly over ``multiple`` devices)."""
    return cdiv(default_num_blocks(layout, batch), multiple) * multiple


def identity_table(batch: int, layout: PagedLayout,
                   device="cpu") -> torch.Tensor:
    """Dense block table: slot b owns blocks [1 + b*mb, 1 + (b+1)*mb)."""
    mb = layout.max_blocks
    return (1 + torch.arange(batch, dtype=torch.int32, device=device)[:, None]
            * mb + torch.arange(mb, dtype=torch.int32, device=device)[None])


def pool_from_rows(rows: torch.Tensor, layout: PagedLayout) -> torch.Tensor:
    """[B, S, ...] rows -> [1 + B*mb, bs, ...] pool whose identity-table
    gather reproduces the zero-padded rows bitwise. A DTensor's rows are
    pooled on each rank, behind a null block of the rank's own: the
    pool's blocks split as the batch does, and a slot's block ids count
    from its shard's start (the ids ``sharding.index_put_rows`` writes
    by); its features split over the model axis as the decode step's
    pools are (``sharding.pool_rows``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(rows, DTensor):
        from repro_torch.distributed.sharding import per_shard, pool_rows
        rows = pool_rows(rows)
        dims = {0: 0, **{i: i for i in range(2, rows.ndim)}}
        return per_shard(lambda r: pool_from_rows(r, layout), (rows,),
                         (dims,), (dims,))
    b, s = rows.shape[:2]
    bs, mb = layout.block_size, layout.max_blocks
    if s > layout.max_context:
        raise ValueError(f"{s} rows exceed {layout}")
    pad = mb * bs - s
    if pad:
        rows = F.pad(rows, (0, 0) * (rows.dim() - 2) + (0, pad))
    blocks = rows.reshape((b * mb, bs) + tuple(rows.shape[2:]))
    null = torch.zeros((1,) + tuple(blocks.shape[1:]), dtype=blocks.dtype,
                       device=blocks.device)
    return torch.cat([null, blocks], dim=0)


def gather_blocks(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[nb, bs, ...] pool + [B, mb] table -> [B, mb*bs, ...] rows."""
    b, mb = table.shape
    bs = pool.shape[1]
    gathered = pool[table.reshape(-1).to(torch.int64)]
    return gathered.reshape((b, mb * bs) + tuple(pool.shape[2:]))


def scatter_token(pool: torch.Tensor, table: torch.Tensor,
                  lens: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """In place: write one token per sequence at its current length.

    pool [nb, bs, ...]; table [B, mb]; lens [B]; vals [B, ...]. Positions
    past the table (an idle slot's drifting length) clip into the last
    table entry, which for an idle slot is the null block."""
    bs, mb = pool.shape[1], table.shape[1]
    lens = lens.to(torch.int64)
    blk_idx = torch.clamp(lens // bs, 0, mb - 1)
    blk = torch.gather(table.to(torch.int64), 1, blk_idx[:, None])[:, 0]
    if type(pool) is torch.Tensor:
        pool.index_put_((blk, lens % bs), vals.to(pool.dtype))
    else:
        from repro_torch.distributed.sharding import index_put_rows
        index_put_rows(pool, (blk, lens % bs), vals.to(pool.dtype))
    return pool


def scatter_chunk(pool: torch.Tensor, table_row: torch.Tensor, pos0: int,
                  vals: torch.Tensor) -> torch.Tensor:
    """In place: write a C-token chunk of ONE sequence at pos0..pos0+C-1.

    pool [nb, bs, ...]; table_row [mb]; vals [C, ...]."""
    c = vals.shape[0]
    bs, mb = pool.shape[1], table_row.shape[0]
    pos = pos0 + torch.arange(c, device=pool.device)
    blk = table_row.to(torch.int64)[torch.clamp(pos // bs, 0, mb - 1)]
    pool.index_put_((blk, pos % bs), vals.to(pool.dtype))
    return pool


def first_occurrence(slots: torch.Tensor) -> torch.Tensor:
    """[S] bool: row s is the first row naming its slot."""
    same = slots[:, None] == slots[None, :]
    return ~torch.tril(same, diagonal=-1).any(dim=1)


def scatter_chunk_multi(pool: torch.Tensor, tables: torch.Tensor,
                        pos0s: torch.Tensor, vals: torch.Tensor,
                        live: torch.Tensor | None = None) -> torch.Tensor:
    """In place: write a C-token chunk for EACH of S sequences at once.

    pool [nb, bs, ...]; tables [S, mb]; pos0s [S]; vals [S, C, ...]. The
    speculative verify pass appends every slot's window in one call.
    Positions past a table's span go to the null block EXPLICITLY: a slot
    that owns every table entry (prompt + max_new == max_context) has no
    null tail to clip into, and a clipped write would overwrite its own
    history. Rows flagged False in ``live`` ([S] bool; the verify frame's
    padding, ``first_occurrence``) also write to the null block:
    ``index_put_`` leaves the winner of duplicate indices undefined on
    CUDA, and a padded copy of a row need not compute that row's values
    (MoE capacity can drop its experts)."""
    s, c = vals.shape[:2]
    bs, mb = pool.shape[1], tables.shape[1]
    pos = (pos0s.to(torch.int64)[:, None]
           + torch.arange(c, device=pool.device)[None, :])       # [S, C]
    blk_idx = pos // bs
    blk = torch.gather(tables.to(torch.int64), 1,
                       torch.clamp(blk_idx, 0, mb - 1))
    keep = blk_idx < mb
    if live is not None:
        keep = keep & live[:, None]
    blk = torch.where(keep, blk, NULL_BLOCK)
    pool.index_put_((blk.reshape(-1), (pos % bs).reshape(-1)),
                    vals.reshape((s * c,) + tuple(vals.shape[2:]))
                    .to(pool.dtype))
    return pool


# ------------------------------------------------------ cache-tree state ---
# Cache trees are dicts of per-layer-stacked leaves: pools [L, nb, bs, ...],
# block_table [L, B, mb], len [L, B]; a Mamba2 stack has recurrent state
# instead, ssm [L, B, H, N, P] and conv [L, B, W-1, conv_dim].

def _per_slot(name: str) -> bool:
    """Leaves with a batch axis that a batched step advances: ``len`` and
    recurrent state (Mamba2 ``ssm`` / ``conv``); not pools or tables."""
    return name not in POOL_KEYS and name != "block_table"


def save_slots(caches: dict, keep_mask: torch.Tensor) -> dict:
    """Copies of the per-slot leaves (``len``, recurrent state) of the
    slots flagged in ``keep_mask`` ([B] bool), taken before a batched
    step, for ``keep_slots``."""
    return {k: v[:, keep_mask].clone() for k, v in caches.items()
            if _per_slot(k)}


def keep_slots(caches: dict, saved: dict, keep_mask: torch.Tensor) -> None:
    """In place: slots flagged in ``keep_mask`` get back the per-slot
    leaves ``save_slots`` copied before a batched step.

    With in-place pools this is all the reference's ``keep_slots`` does:
    a mid-prefill slot's stray decode write lands in its own block at a
    position its next chunk rewrites (or in the null block), so only its
    length must not advance; a Mamba2 slot's state and conv window would
    be advanced for good, so they are put back too."""
    for k, v in saved.items():
        caches[k][:, keep_mask] = v


def set_lens(caches: dict, slots: torch.Tensor, new_lens: torch.Tensor
             ) -> None:
    """In place: ``len[:, slots] = new_lens`` for every layer."""
    caches["len"][:, slots.to(torch.int64)] = new_lens.to(torch.int32)


def _block_index(caches: dict, blocks) -> torch.Tensor:
    return torch.as_tensor(list(blocks), dtype=torch.int64,
                           device=caches["len"].device)


def copy_block(caches: dict, src: int, dst: int) -> None:
    """In place: copy pool block ``src`` to ``dst`` in every pool leaf and
    layer (scale tiles and MLA latents included: they ride the same block
    ids). The copy-on-write step of prefix caching: a request diverging
    mid-block from a cached prefix gets a private copy of the divergence
    block, and the shared original stays bit-identical for its other
    readers."""
    for name in POOL_KEYS:
        if name in caches:
            leaf = caches[name]
            leaf[:, dst] = leaf[:, src]


def extract_blocks(caches: dict, blocks) -> dict:
    """Gather the listed blocks out of every pool leaf to host memory:
    ``{leaf name: CPU tensor [L, len(blocks), block_size, ...]}``.

    The device half of preemption to host and of the prefix spill tier.
    The snapshot covers every pool leaf (quantized payloads and their
    scale tiles alike), so a restore is bit-identical however the pool is
    quantized. Block ids are not part of it: content is addressed through
    the slot's table, so a snapshot restores bitwise into any other
    blocks. From a CUDA pool the copies land in pinned host memory,
    started without blocking and waited for once at the end, so the
    snapshot is complete when this returns."""
    idx = _block_index(caches, blocks)
    on_cuda = caches["len"].is_cuda
    out = {}
    for name in POOL_KEYS:
        if name not in caches:
            continue
        rows = caches[name][:, idx]
        if on_cuda:
            host = torch.empty(rows.shape, dtype=rows.dtype,
                               pin_memory=True)
            host.copy_(rows, non_blocking=True)
        else:
            host = rows
        out[name] = host
    if on_cuda:
        torch.cuda.current_stream(caches["len"].device).synchronize()
    return out


def restore_blocks(caches: dict, blocks, snapshot: dict) -> None:
    """In place: scatter an ``extract_blocks`` snapshot into the (possibly
    different) ``blocks``; pool leaves absent from ``snapshot`` and all
    per-slot state are left alone. A pinned snapshot is uploaded without
    blocking the host."""
    idx = _block_index(caches, blocks)
    for name, snap in snapshot.items():
        leaf = caches[name]
        leaf[:, idx] = snap.to(leaf.device, non_blocking=True)


def concat_block_snapshots(snaps: list) -> dict:
    """Merge per-block ``extract_blocks`` snapshots along the block axis,
    so a k-block promote is one upload and one scatter per leaf (into
    pinned memory when the parts are pinned)."""
    if len(snaps) == 1:
        return snaps[0]
    out = {}
    for k in snaps[0]:
        parts = [s[k] for s in snaps]
        shape = list(parts[0].shape)
        shape[1] = sum(p.shape[1] for p in parts)
        out[k] = torch.cat(parts, dim=1, out=torch.empty(
            shape, dtype=parts[0].dtype, pin_memory=parts[0].is_pinned()))
    return out


def snapshot_bytes(snapshot: dict) -> int:
    """Host bytes an ``extract_blocks`` snapshot holds."""
    return sum(t.nbytes for t in snapshot.values())


def zero_blocks(caches: dict, blocks: list[int]) -> None:
    """In place: zero the listed blocks of every pool leaf (the quarantine
    scrub: a recycled block must not carry NaNs, since masked attention
    still multiplies them by an exact 0)."""
    idx = _block_index(caches, blocks)
    for name in POOL_KEYS:
        if name in caches:
            caches[name][:, idx] = 0


def poison_blocks(caches: dict, blocks: list[int]) -> None:
    """In place: NaN-fill the listed blocks of every float pool leaf
    (fault injection's silent KV corruption, which the numerics guard
    must catch). Integer payloads (int8, and fp8 stored as e4m3 bytes)
    keep their bits; their f32 scale tiles take the NaN, which
    dequantizes to NaN all the same."""
    idx = _block_index(caches, blocks)
    for name in POOL_KEYS:
        if name in caches and caches[name].is_floating_point():
            caches[name][:, idx] = float("nan")


def reset_slot(caches: dict, slot: int, table_row: torch.Tensor) -> None:
    """In place: point slot ``slot`` at ``table_row`` in every layer, zero
    its length and its recurrent state (Mamba2 ``ssm`` / ``conv``); pools
    are untouched."""
    for k, v in caches.items():
        if k == "block_table":
            v[:, slot, :] = table_row.to(torch.int32)
        elif _per_slot(k):
            v[:, slot] = 0
