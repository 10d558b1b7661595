"""Naive (uncompensated) scalar product of (M, 128) operands: the
paper's baseline as the historical ``naive_dot_blocked`` entry point
(twin of ``repro.kernels.naive_dot``), the reduction engine with
``compensated=False``."""

from __future__ import annotations

import torch

from repro_torch.kernels import engine
from repro_torch.kernels.kahan_dot import check_blocked


def naive_dot_blocked(x2d: torch.Tensor, y2d: torch.Tensor) -> torch.Tensor:
    """Naive dot of two (M, 128) tensors -> 0-d f32 scalar."""
    check_blocked(x2d, y2d)
    (out,) = engine.fused_reduce_flat((x2d.reshape(-1), y2d.reshape(-1)),
                                      outputs=("dot",), compensated=False)
    return out
