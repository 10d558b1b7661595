"""Compensated sum of an (M, 128) operand: the historical
``kahan_sum_blocked`` entry point (twin of ``repro.kernels.kahan_sum``),
a shim over the reduction engine. The plain twin streams in the
engine's default blocks; the reference shim asks for 512-row blocks,
which changes its stream layout (and the last bits of the compensated
sum) only from 64 Ki elements up."""

from __future__ import annotations

import torch

from repro_torch.kernels import engine
from repro_torch.kernels.kahan_dot import check_blocked


def kahan_sum_blocked(x2d: torch.Tensor) -> torch.Tensor:
    """Compensated sum of an (M, 128) tensor -> 0-d f32 scalar."""
    check_blocked(x2d)
    (out,) = engine.fused_reduce_flat((x2d.reshape(-1),), outputs=("sum",))
    return out
