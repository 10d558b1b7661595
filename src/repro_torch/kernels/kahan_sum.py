"""Compensated sum of an (M, 128) operand: the historical
``kahan_sum_blocked`` entry point (twin of ``repro.kernels.kahan_sum``),
a shim over the reduction engine, in the reference's 512-row blocks by
default."""

from __future__ import annotations

import torch

from repro_torch.kernels import engine
from repro_torch.kernels.kahan_dot import check_blocked


def kahan_sum_blocked(x2d: torch.Tensor, *, block_rows: int = 512,
                      unroll: int | None = None) -> torch.Tensor:
    """Compensated sum of an (M, 128) tensor -> 0-d f32 scalar."""
    check_blocked(x2d)
    (out,) = engine.fused_reduce_flat(
        (x2d.reshape(-1),), outputs=("sum",), unroll=unroll,
        block_elems=engine.block_elems_for(x2d.numel(), unroll, block_rows))
    return out
