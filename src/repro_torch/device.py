"""Device resolution for the port's entry points.

``None`` means the card: the port is written for an H100, so an entry
point called without a device runs on CUDA, and raises when there is no
GPU rather than quietly running on the CPU. Callers that want the CPU
(the parity tests) ask for it explicitly.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; an explicit device passes through. Raises
    ``RuntimeError`` if a CUDA device is requested and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def set_numerics() -> None:
    """Full-f32 matmuls on the card: the serving logits are an f32
    [B, d] x [d, vocab] product whose argmax TF32 could change."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
