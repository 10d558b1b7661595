"""Dispatch surface for the port's kernels (twin of ``repro.kernels.ops``).

Each entry point picks by the device of its input: a CPU tensor runs the
plain PyTorch twin, a CUDA tensor launches the hand-written kernel (or
raises — there is no fallback). ``launches`` is the per-kernel count of
wrapper calls that launched on the card (kept by the ``*_cuda`` wrappers,
see ``kernels/_build.py``), so a run can show that its main path went
through the kernels; ``reset_launches`` zeroes it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import engine
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels._build import launches, reset_launches  # noqa: F401


# ------------------------------------------------------------ reductions --

def batched_fused_reduce(x: torch.Tensor, y: torch.Tensor | None = None, *,
                         outputs=("sum", "sumsq", "maxabs"),
                         compensated: bool = True) -> dict:
    """Row-wise fused reduction: (B, N) -> {output: (B,)} in one call."""
    if x.dim() != 2:
        raise ValueError(f"batched_fused_reduce takes (B, N), got {x.shape}")
    outputs = tuple(outputs)
    if "dot" in outputs and y is None:
        raise ValueError("'dot' output requires the second operand y")
    operands = (x, y) if "dot" in outputs else (x,)
    outs = engine.fused_reduce_rows(operands, outputs=outputs,
                                    compensated=compensated)
    return dict(zip(outputs, outs))


def fused_reduce(x: torch.Tensor, y: torch.Tensor | None = None, *,
                 outputs=("sum", "sumsq", "maxabs"),
                 compensated: bool = True) -> dict:
    """One streaming pass over the flattened operands -> {output: scalar}:
    the batched form at B = 1."""
    if y is not None and y.shape != x.shape:
        raise ValueError("x and y must have the same shape")
    out = batched_fused_reduce(
        x.reshape(1, -1), None if y is None else y.reshape(1, -1),
        outputs=outputs, compensated=compensated)
    return {k: v[0] for k, v in out.items()}


def kahan_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Compensated scalar product of two same-shape tensors -> scalar."""
    return fused_reduce(x, y, outputs=("dot",))["dot"]


def kahan_sum(x: torch.Tensor) -> torch.Tensor:
    """Compensated full-tensor sum -> scalar."""
    return fused_reduce(x, outputs=("sum",))["sum"]


def naive_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Baseline (uncompensated) scalar product -> scalar."""
    return fused_reduce(x, y, outputs=("dot",), compensated=False)["dot"]


# ------------------------------------------------------------ attention ---

def paged_attention(q: torch.Tensor, kpool: torch.Tensor,
                    vpool: torch.Tensor, block_table: torch.Tensor,
                    lens: torch.Tensor, *,
                    q_offsets: torch.Tensor | None = None,
                    kscale: torch.Tensor | None = None,
                    vscale: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """THE serving attention dispatch (GQA superkernel): q [B, W, Hq, D]
    against pools [nb, bs, Hkv, D] through ``block_table``; row w sits at
    ``q_offsets + w`` (default ``lens - W``: the window was just
    appended). Returns [B, W, Hq, Dv] in q's dtype."""
    if q.dim() != 4 or kpool.dim() != 4:
        raise ValueError(f"GQA paged attention takes q [B, W, Hq, D] and "
                         f"pools [nb, bs, Hkv, D]; got {tuple(q.shape)}, "
                         f"{tuple(kpool.shape)}")
    lens = lens.to(torch.int32)
    offs = (lens - q.shape[1] if q_offsets is None
            else q_offsets.to(torch.int32))
    args = (q, kpool, vpool, block_table.to(torch.int32).contiguous(),
            lens.contiguous(), offs.contiguous())
    if q.is_cuda:
        return _pa.paged_attention_cuda(*args, kscale=kscale, vscale=vscale,
                                        scale=scale)
    return _pa.paged_attention_plain(*args, kscale=kscale, vscale=vscale,
                                     scale=scale)
