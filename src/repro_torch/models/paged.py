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


def default_num_blocks(layout: PagedLayout, batch: int) -> int:
    """Pool size that holds ``batch`` full-context sequences + null."""
    return 1 + batch * layout.max_blocks


def identity_table(batch: int, layout: PagedLayout,
                   device="cpu") -> torch.Tensor:
    """Dense block table: slot b owns blocks [1 + b*mb, 1 + (b+1)*mb)."""
    mb = layout.max_blocks
    return (1 + torch.arange(batch, dtype=torch.int32, device=device)[:, None]
            * mb + torch.arange(mb, dtype=torch.int32, device=device)[None])


def pool_from_rows(rows: torch.Tensor, layout: PagedLayout) -> torch.Tensor:
    """[B, S, ...] rows -> [1 + B*mb, bs, ...] pool whose identity-table
    gather reproduces the zero-padded rows bitwise."""
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
    pool.index_put_((blk, lens % bs), vals.to(pool.dtype))
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


# ------------------------------------------------------ cache-tree state ---
# Cache trees are dicts of per-layer-stacked leaves: pools [L, nb, bs, ...],
# block_table [L, B, mb], len [L, B].

def keep_slots(caches: dict, old_len: torch.Tensor,
               keep_mask: torch.Tensor) -> None:
    """In place: slots flagged in ``keep_mask`` ([B] bool) get back their
    ``len`` from ``old_len`` ([L, B], saved before a batched step).

    With in-place pools this is all the reference's ``keep_slots`` leaves
    to do for attention caches: a mid-prefill slot's stray decode write
    lands in its own block at a position its next chunk rewrites (or in
    the null block); only its length must not advance."""
    caches["len"][:, keep_mask] = old_len[:, keep_mask]


def set_lens(caches: dict, slots: torch.Tensor, new_lens: torch.Tensor
             ) -> None:
    """In place: ``len[:, slots] = new_lens`` for every layer."""
    caches["len"][:, slots.to(torch.int64)] = new_lens.to(torch.int32)


def zero_blocks(caches: dict, blocks: list[int]) -> None:
    """In place: zero the listed blocks of every pool leaf (the quarantine
    scrub: a recycled block must not carry NaNs, since masked attention
    still multiplies them by an exact 0)."""
    idx = torch.as_tensor(blocks, dtype=torch.int64,
                          device=caches["len"].device)
    for name in POOL_KEYS:
        if name in caches:
            caches[name][:, idx] = 0


def reset_slot(caches: dict, slot: int, table_row: torch.Tensor) -> None:
    """In place: point slot ``slot`` at ``table_row`` in every layer and
    zero its length; pools are untouched."""
    caches["block_table"][:, slot, :] = table_row.to(torch.int32)
    caches["len"][:, slot] = 0
