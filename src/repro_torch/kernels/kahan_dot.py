"""Compensated scalar product of (M, 128) operands: the historical
``kahan_dot_blocked`` entry point (twin of ``repro.kernels.kahan_dot``),
a shim over the reduction engine (``kernels.engine``; the plain twin on
a CPU tensor, ``csrc/fused_reduce.cu`` on a CUDA tensor). ``block_rows``
and ``unroll`` set the plain twin's block schedule as they set the
reference's."""

from __future__ import annotations

import torch

from repro_torch.kernels import engine
from repro_torch.kernels.engine import LANES


def check_blocked(*operands: torch.Tensor) -> None:
    """(M, 128) operands of one shape, or ``ValueError``."""
    x = operands[0]
    if x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"blocked operands are (M, {LANES}), got "
                         f"{tuple(x.shape)}")
    if any(op.shape != x.shape for op in operands):
        raise ValueError("operands must have one shape")


def kahan_dot_blocked(x2d: torch.Tensor, y2d: torch.Tensor, *,
                      block_rows: int = 256,
                      unroll: int | None = None) -> torch.Tensor:
    """Compensated dot of two (M, 128) tensors -> 0-d f32 scalar."""
    check_blocked(x2d, y2d)
    (out,) = engine.fused_reduce_flat(
        (x2d.reshape(-1), y2d.reshape(-1)), outputs=("dot",), unroll=unroll,
        block_elems=engine.block_elems_for(x2d.numel(), unroll, block_rows))
    return out
