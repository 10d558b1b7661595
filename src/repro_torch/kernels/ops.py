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

from repro_torch.kernels import engine, traced
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels._build import launches, reset_launches  # noqa: F401
from repro_torch.kernels.kahan_acc import (kahan_acc_flat_cuda,
                                           kahan_acc_flat_plain)
from repro_torch.kernels.kahan_matmul import kahan_matmul_q8


# ------------------------------------------------------------ reductions --
# ``unroll`` and ``block_rows`` are the reference's knobs: they set the
# plain twin's stream layout (bitwise the reference's); the kernel checks
# them and streams in its own layout (``kernels.engine``).

def batched_fused_reduce(x: torch.Tensor, y: torch.Tensor | None = None, *,
                         outputs=("sum", "sumsq", "maxabs"),
                         unroll: int | None = None,
                         compensated: bool = True) -> dict:
    """Row-wise fused reduction: (B, N) -> {output: (B,)} in one call."""
    if x.dim() != 2:
        raise ValueError(f"batched_fused_reduce takes (B, N), got {x.shape}")
    outputs = tuple(outputs)
    if "dot" in outputs and y is None:
        raise ValueError("'dot' output requires the second operand y")
    operands = (x, y) if "dot" in outputs else (x,)
    outs = engine.fused_reduce_rows(operands, outputs=outputs, unroll=unroll,
                                    compensated=compensated)
    return dict(zip(outputs, outs))


def fused_reduce(x: torch.Tensor, y: torch.Tensor | None = None, *,
                 outputs=("sum", "sumsq", "maxabs"),
                 unroll: int | None = None,
                 compensated: bool = True) -> dict:
    """One streaming pass over the flattened operands -> {output: scalar}:
    the batched form at B = 1."""
    if y is not None and y.shape != x.shape:
        raise ValueError("x and y must have the same shape")
    out = batched_fused_reduce(
        x.reshape(1, -1), None if y is None else y.reshape(1, -1),
        outputs=outputs, unroll=unroll, compensated=compensated)
    return {k: v[0] for k, v in out.items()}


def batched_kahan_dot(x: torch.Tensor, y: torch.Tensor, *,
                      unroll: int | None = None) -> torch.Tensor:
    """Many independent compensated dots in one call: (B, N) x (B, N) ->
    (B,)."""
    if x.dim() != 2 or x.shape != y.shape:
        raise ValueError(f"batched_kahan_dot takes two (B, N) tensors, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    return batched_fused_reduce(x, y, outputs=("dot",), unroll=unroll)["dot"]


def _scalar(operands, output: str, block_rows, unroll,
            compensated: bool = True) -> torch.Tensor:
    """One output over the flattened operands, in the blocks that
    ``block_rows`` / ``unroll`` select."""
    if any(op.shape != operands[0].shape for op in operands):
        raise ValueError("x and y must have the same shape")
    flat = tuple(op.reshape(-1) for op in operands)
    (out,) = engine.fused_reduce_flat(
        flat, outputs=(output,), unroll=unroll, compensated=compensated,
        block_elems=engine.block_elems_for(flat[0].numel(), unroll,
                                           block_rows))
    return out


def kahan_dot(x: torch.Tensor, y: torch.Tensor, *,
              block_rows: int | None = None,
              unroll: int | None = None) -> torch.Tensor:
    """Compensated scalar product of two same-shape tensors -> scalar."""
    return _scalar((x, y), "dot", block_rows, unroll)


def kahan_sum(x: torch.Tensor, *, block_rows: int | None = None,
              unroll: int | None = None) -> torch.Tensor:
    """Compensated full-tensor sum -> scalar."""
    return _scalar((x,), "sum", block_rows, unroll)


def naive_dot(x: torch.Tensor, y: torch.Tensor, *,
              block_rows: int | None = None,
              unroll: int | None = None) -> torch.Tensor:
    """Baseline (uncompensated) scalar product -> scalar."""
    return _scalar((x, y), "dot", block_rows, unroll, compensated=False)


# ------------------------------------------------------------ attention ---

def paged_attention(q: torch.Tensor, kpool: torch.Tensor,
                    vpool: torch.Tensor | None, block_table: torch.Tensor,
                    lens: torch.Tensor, *,
                    q_offsets: torch.Tensor | None = None,
                    kscale: torch.Tensor | None = None,
                    vscale: torch.Tensor | None = None,
                    q_rope: torch.Tensor | None = None,
                    rope_pool: torch.Tensor | None = None,
                    rope_scale: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """THE serving attention dispatch (the superkernel): W query rows per
    sequence through ``block_table``; row w sits at ``q_offsets + w``
    (default ``lens - W``: the window was just appended).

    GQA: q [B, W, Hq, D] against pools [nb, bs, Hkv, D] (int8/fp8 pools
    pass kscale/vscale [nb, bs, Hkv]). Returns [B, W, Hq, Dv] in q's
    dtype.

    MLA latents: the c_kv pool [nb, bs, C] as ``kpool`` with
    ``vpool=None`` (the value IS the latent), the rope stream through
    ``q_rope`` [B, W, H, R] / ``rope_pool`` [nb, bs, R], per-token
    ``kscale``/``rope_scale`` [nb, bs] when quantized, and the explicit
    MLA softmax ``scale``. Returns the context latents [B, W, H, C] f32.
    """
    latent = q_rope is not None
    if latent:
        if vpool is not None or rope_pool is None or kpool.dim() != 3 \
                or q.dim() != 4 or scale is None:
            raise ValueError("MLA paged attention takes q [B, W, H, C], "
                             "kpool [nb, bs, C], vpool=None, rope_pool and "
                             "the explicit softmax scale")
    elif q.dim() != 4 or kpool.dim() != 4 or vpool is None:
        raise ValueError(f"GQA paged attention takes q [B, W, Hq, D] and "
                         f"pools [nb, bs, Hkv, D]; got {tuple(q.shape)}, "
                         f"{tuple(kpool.shape)}")
    lens = lens.to(torch.int32)
    offs = (lens - q.shape[1] if q_offsets is None
            else q_offsets.to(torch.int32))
    table = block_table.to(torch.int32).contiguous()
    if latent:
        args = (q.contiguous(), q_rope.contiguous(), kpool, rope_pool, table,
                lens.contiguous(), offs.contiguous())
        fn = (_pa.paged_latent_attention_cuda if traced.on_card(q)
              else _pa.paged_latent_attention_plain)
        return fn(*args, ck_scale=kscale, kr_scale=rope_scale, scale=scale)
    # q arrives transposed in memory from rope when W > 1 (a verify window)
    args = (q.contiguous(), kpool, vpool, table, lens.contiguous(),
            offs.contiguous())
    if traced.on_card(q):
        return _pa.paged_attention_cuda(*args, kscale=kscale, vscale=vscale,
                                        scale=scale)
    return _pa.paged_attention_plain(*args, kscale=kscale, vscale=vscale,
                                     scale=scale)


# ------------------------------------------------------ quantized matmul --

def q8_matmul(a: torch.Tensor, qw: torch.Tensor,
              scales: torch.Tensor) -> torch.Tensor:
    """A @ dequant(qw) with compensated f32 K-accumulation -> f32 [M, N];
    ``qw`` / ``scales`` from ``quant.core.quantize_weight`` (int8, or fp8
    as u8 bytes). See ``kernels.kahan_matmul.kahan_matmul_q8``."""
    return kahan_matmul_q8(a, qw, scales)


# ------------------------------------------------------------ acc ---------

def kahan_accumulate(acc_sum: torch.Tensor, acc_carry: torch.Tensor,
                     update: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Elementwise compensated accumulate of same-shape tensors, IN PLACE:
    ``acc_sum`` / ``acc_carry`` are updated and returned (the reference
    returns new arrays aliased onto its inputs). The kernel on a CUDA
    tensor (contiguous, f32 accumulators), the plain twin on a CPU one.
    See ``kernels.kahan_acc``."""
    if traced.on_card(acc_sum):
        return kahan_acc_flat_cuda(acc_sum, acc_carry, update)
    return kahan_acc_flat_plain(acc_sum, acc_carry, update)
