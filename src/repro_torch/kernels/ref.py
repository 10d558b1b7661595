"""Plain oracles for the reduction kernels (twin of ``repro.kernels.ref``).

Three tiers of reference:
  * ``*_ref``    — the kernels' numerics *algorithm* in plain PyTorch
                   (sequential Kahan/Neumaier, the scan form);
  * ``exact_*``  — ground truth via ``math.fsum`` over float64 products
                   (error-free up to the final rounding);
  * ``naive_*``  — the paper's baseline (straightforward accumulation).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import kahan


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def naive_dot_ref(x, y) -> torch.Tensor:
    """Paper baseline: plain f32 sum of the products."""
    return torch.sum(_f32(x) * _f32(y))


def naive_sum_ref(x) -> torch.Tensor:
    return torch.sum(_f32(x))


def kahan_dot_ref(x, y) -> torch.Tensor:
    """Sequential compensated dot (scan) — the paper's Fig. 2b semantics."""
    return kahan.kahan_sum(_f32(x) * _f32(y), axis=0)


def kahan_sum_ref(x) -> torch.Tensor:
    return kahan.kahan_sum(_f32(x), axis=0)


def kahan_acc_ref(acc_sum, acc_carry, update):
    """Elementwise Neumaier accumulate (grad-accumulation oracle)."""
    return kahan.neumaier_step(_f32(acc_sum), _f32(acc_carry), _f32(update))


# ---------------------------------------------------------------- exact ----

def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy().reshape(-1)
    return np.asarray(x, dtype=np.float64).reshape(-1)


def exact_dot(x, y) -> float:
    """Error-free dot via fsum over float64 products (exact for f32 and
    bf16 inputs, so one final rounding)."""
    return math.fsum((_f64(x) * _f64(y)).tolist())


def exact_sum(x) -> float:
    return math.fsum(_f64(x).tolist())


def condition_number(x) -> float:
    """Summation condition number: sum|x| / |sum x|."""
    xf = _f64(x)
    denom = abs(math.fsum(xf.tolist()))
    return float(np.sum(np.abs(xf)) / max(denom, np.finfo(np.float64).tiny))
