"""Symmetric block quantization (twin of ``repro.quant.core``).

Three granularities of one scheme (symmetric, per-tile amax scale):
``quantize_lastdim`` (one scale per trailing vector: the KV pools),
``quantize_blocks`` (flat blocks of ``EF_BLOCK`` elements) and
``quantize_weight`` (one scale per (K-block, output column) of a [K, N]
weight: the K-block of ``kernels.kahan_matmul.kahan_matmul_q8``).

int8 payloads are stored as ``torch.int8``; fp8 (e4m3fn) payloads are
stored as their raw bytes in ``torch.uint8`` and widened with the same
bit trick as the reference, so the two NaN encodings 0x7f/0xff widen to
±480 on both sides. Scales are f32, one per trailing vector.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EF_BLOCK = 256
SCALE_EPS = 1e-12


class QuantFormat(NamedTuple):
    """A symmetric quantization target: value dtype + max magnitude."""

    name: str
    dtype: torch.dtype
    qmax: float

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def storage(self) -> torch.dtype:
        """Payload dtype as stored: fp8 payloads are raw e4m3 bytes."""
        if self.dtype == torch.float8_e4m3fn:
            return torch.uint8
        return self.dtype


INT8 = QuantFormat("int8", torch.int8, 127.0)
FP8 = QuantFormat("fp8", torch.float8_e4m3fn, 448.0)

FORMATS: dict[str, QuantFormat | None] = {"bf16": None, "int8": INT8,
                                          "fp8": FP8}


def get_format(kv_dtype: str) -> QuantFormat | None:
    """Resolve a ``kv_dtype`` knob; None means 'not quantized'."""
    if kv_dtype not in FORMATS:
        raise ValueError(f"unknown quant format {kv_dtype!r}; "
                         f"known: {sorted(FORMATS)}")
    return FORMATS[kv_dtype]


def e4m3_to_f32(q: torch.Tensor) -> torch.Tensor:
    """Widen e4m3fn bytes (uint8, or float8_e4m3fn values) to f32.

    e4m3 (1-4-3) is a bit-subset of f16 (1-5-10): sign to bit 15,
    exponent+mantissa to bits 14..7 gives an f16 biased 15 instead of 7,
    so the f16 -> f32 widen times 2^8 is the value, denormals included.
    """
    u8 = q if q.dtype == torch.uint8 else q.view(torch.uint8)
    u = u8.to(torch.int32)
    u16 = ((u & 0x80) << 8) | ((u & 0x7F) << 7)
    return u16.to(torch.int16).view(torch.float16).to(torch.float32) * 256.0


def cast_f32(x: torch.Tensor) -> torch.Tensor:
    """Widen any pool payload to f32; uint8 payloads ARE fp8 here."""
    if x.dtype in (torch.float8_e4m3fn, torch.uint8):
        return e4m3_to_f32(x)
    return x.to(torch.float32)


def _encode(x: torch.Tensor, scale: torch.Tensor, fmt: QuantFormat
            ) -> torch.Tensor:
    y = x / scale
    if fmt.dtype == torch.int8:
        # torch.round is round-half-even, like jnp.round
        return torch.clamp(torch.round(y), -fmt.qmax, fmt.qmax).to(torch.int8)
    return y.to(fmt.dtype).view(fmt.storage)


def quantize_lastdim(x: torch.Tensor, fmt: QuantFormat
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (payload [..., D] in ``fmt.storage``, f32 scales
    [...])."""
    x = x.to(torch.float32)
    amax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.clamp_min(amax / fmt.qmax, SCALE_EPS)
    return _encode(x, scale[..., None], fmt), scale


def dequantize_lastdim(q: torch.Tensor, scales: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_lastdim``: q [..., D], scales [...] ->
    [..., D] in ``dtype``."""
    return (cast_f32(q) * scales[..., None]).to(dtype)


def quantize_blocks(x: torch.Tensor, fmt: QuantFormat = INT8,
                    block: int = EF_BLOCK
                    ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Flatten, zero-pad to a ``block`` multiple, one scale per block:
    (payload [nblocks, block], f32 scales [nblocks, 1], pad). The scale
    is computed in ``x``'s dtype, as the reference does."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / fmt.qmax
    scale = torch.clamp_min(scale, SCALE_EPS)
    return _encode(blocks, scale, fmt), scale.to(torch.float32), pad


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, pad: int,
                      shape: tuple) -> torch.Tensor:
    """Inverse of ``quantize_blocks`` back to ``shape`` (f32)."""
    out = (cast_f32(q) * scales).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(shape)


def quantize_weight(w: torch.Tensor, fmt: QuantFormat = INT8,
                    block_k: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """[K, N] weight -> (payload [K, N] in ``fmt.storage``, f32 scales
    [K // block_k, N]): one scale per (K-block, output column)."""
    k, n = w.shape
    if k % block_k:
        raise ValueError(f"K={k} is not a multiple of block_k={block_k}")
    wb = w.to(torch.float32).reshape(k // block_k, block_k, n)
    amax = torch.amax(torch.abs(wb), dim=1)
    scale = torch.clamp_min(amax / fmt.qmax, SCALE_EPS)
    return _encode(wb, scale[:, None, :], fmt).reshape(k, n), scale


def dequantize_weight(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_weight`` -> f32 [K, N]; fp8 (u8) payloads
    widen as e4m3."""
    nk, n = scales.shape
    k = q.shape[0]
    wb = cast_f32(q).reshape(nk, k // nk, n)
    return (wb * scales[:, None, :]).reshape(k, n)
