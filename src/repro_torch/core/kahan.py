"""Compensated-summation primitives (the paper's core algorithm, §4.2).

Twin of ``repro.core.kahan``: the same branch-free f32 operation
sequences, written as separate PyTorch ops so every add rounds on its
own (PyTorch never reassociates or contracts elementwise ops), which
keeps them bitwise equal to the reference.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def twosum(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Knuth TwoSum: (s, e) with s = fl(a + b) and s + e == a + b."""
    s = a + b
    a_prime = s - b
    b_prime = s - a_prime
    da = a - a_prime
    db = b - b_prime
    return s, da + db


def kahan_step(s: Tensor, c: Tensor, x: Tensor) -> tuple[Tensor, Tensor]:
    """One classic Kahan update (``c`` holds the negative compensation)."""
    y = x - c
    t = s + y
    c_new = (t - s) - y
    return t, c_new


def neumaier_step(s: Tensor, c: Tensor, x: Tensor) -> tuple[Tensor, Tensor]:
    """Kahan–Babuška–Neumaier update; the represented value is s + c."""
    t, e = twosum(s, x)
    return t, c + e


def combine(s1: Tensor, c1: Tensor, s2: Tensor, c2: Tensor
            ) -> tuple[Tensor, Tensor]:
    """Merge two Neumaier partials (s1 + c1) and (s2 + c2)."""
    s, e = twosum(s1, s2)
    return s, c1 + c2 + e


def value(s: Tensor, c: Tensor) -> Tensor:
    return s + c


def kahan_sum(x: Tensor, axis: int = -1, *, variant: str = "neumaier"
              ) -> Tensor:
    """Compensated sum along ``axis`` in sequential order (the scan form)."""
    step = neumaier_step if variant == "neumaier" else kahan_step
    x = torch.movedim(x, axis, 0)
    s = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    c = torch.zeros_like(s)
    for xi in x:
        s, c = step(s, c, xi)
    return s + c if variant == "neumaier" else s


def kahan_dot(a: Tensor, b: Tensor, *, variant: str = "neumaier") -> Tensor:
    """Compensated scalar product, scan form."""
    return kahan_sum(a * b, axis=0, variant=variant)
