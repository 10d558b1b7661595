"""Naive (uncompensated) scalar product of (M, 128) operands: the
paper's baseline as the historical ``naive_dot_blocked`` entry point
(twin of ``repro.kernels.naive_dot``), the reduction engine with
``compensated=False``; one stream (``unroll=1``) unless asked, as the
reference."""

from __future__ import annotations

import torch

from repro_torch.kernels import engine
from repro_torch.kernels.kahan_dot import check_blocked


def naive_dot_blocked(x2d: torch.Tensor, y2d: torch.Tensor, *,
                      block_rows: int = 256,
                      unroll: int | None = None) -> torch.Tensor:
    """Naive dot of two (M, 128) tensors -> 0-d f32 scalar."""
    check_blocked(x2d, y2d)
    u = 1 if unroll is None else unroll
    (out,) = engine.fused_reduce_flat(
        (x2d.reshape(-1), y2d.reshape(-1)), outputs=("dot",), unroll=u,
        compensated=False,
        block_elems=engine.block_elems_for(x2d.numel(), u, block_rows))
    return out
