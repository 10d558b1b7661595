"""Error-feedback gradient compression for the thin cross-pod links (twin
of ``repro.distributed.compression``).

An int8 block-quantized all-reduce with an error-feedback residual: the
residual is the paper's compensation term generalized to lossy
accumulation. The quantization error is carried, not dropped, so the
long-run accumulated gradient is unbiased (EF-SGD); 4x fewer bytes on
the pods' axis at the cost of per-step quantization noise that the
residual repays. The quantizer is ``quant.core.quantize_blocks``, the
one the KV pools use, in the reference's order of operations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import _check_device, ring_shift
from repro_torch.quant import core as qcore

BLOCK = qcore.EF_BLOCK


class EFState(NamedTuple):
    residual: torch.Tensor       # the gradient's shape, f32


def ef_init(x: torch.Tensor) -> EFState:
    return EFState(residual=torch.zeros_like(x, dtype=torch.float32))


def ef_quantized_all_reduce(grad: torch.Tensor, state: EFState, group=None
                            ) -> tuple[torch.Tensor, EFState]:
    """On every rank of ``group``: compress (grad + residual), pass the
    int8 payloads around the ring and sum them dequantized, keep the
    local quantization error as the new residual."""
    _check_device(grad, group)
    n = dist.get_world_size(group)
    x = grad.to(torch.float32) + state.residual
    q, scale, pad = qcore.quantize_blocks(x, qcore.INT8, BLOCK)
    local_deq = qcore.dequantize_blocks(q, scale, pad, grad.shape)
    new_residual = x - local_deq
    total, bq, bs = local_deq, q, scale
    for _ in range(n - 1):
        bq = ring_shift(bq, group)
        bs = ring_shift(bs, group)
        total = total + qcore.dequantize_blocks(bq, bs, pad, grad.shape)
    return total, EFState(new_residual)


def compressed_bytes_per_element() -> float:
    """1 int8 + one f32 scale per BLOCK, against 4 B of f32."""
    return 1.0 + 4.0 / BLOCK
