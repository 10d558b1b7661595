"""Parameter schemas and shared layer primitives (twin of
``repro.models.common``).

Parameters are plain nested dicts of tensors built from a declarative
schema, in the reference's dtypes (f32). ``dense`` computes what the
reference's bf16 einsum with f32 accumulation computes: both operands are
rounded to bf16 and multiplied in f32 (bf16 x bf16 products are exact in
f32), the bias is added in f32, and the result is rounded once to bf16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""
    shape: tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | fan_in
    scale: float = 0.02
    dtype: torch.dtype = torch.float32


def _flatten_schema(schema: dict, prefix: str = "") -> list:
    out = []
    for k in sorted(schema):
        v = schema[k]
        path = f"{prefix}{k}"
        if isinstance(v, ParamSpec):
            out.append((path, v))
        else:
            out.extend(_flatten_schema(v, prefix=path + "/"))
    return out


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    # the reference's fan_in is the leading axis of the (possibly
    # layer-stacked) leaf, which this reproduces
    fan_in = spec.shape[0] if spec.shape else 1
    scale = (1.0 / math.sqrt(max(fan_in, 1)) if spec.init == "fan_in"
             else spec.scale)
    x = torch.randn(spec.shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(spec.dtype)


def init_params(schema: dict, generator: torch.Generator,
                device) -> dict:
    """Materialize a parameter tree from a schema, leaves drawn in sorted
    path order from ``generator`` (which must live on ``device``)."""
    tree: dict = {}
    for path, spec in _flatten_schema(schema):
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _init_leaf(spec, generator, device)
    return tree


# ------------------------------------------------------------ primitives ---

def rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def norm_schema(d: int) -> dict:
    return {"scale": ParamSpec((d,), init="ones")}


def rope_frequencies(head_dim: int, theta: float,
                     device="cpu") -> torch.Tensor:
    exponents = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                              device=device) / head_dim)
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 1e4, rotary_dim: int | None = None
               ) -> torch.Tensor:
    """x: [..., L, D]; positions broadcastable to [..., L]."""
    d = x.shape[-1]
    rd = rotary_dim or d
    freqs = rope_frequencies(rd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    x1, x2 = torch.chunk(x_rot.to(torch.float32), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ w (+ b): operands rounded to ``compute_dtype``, f32
    accumulation, bias added in f32, one rounding to ``compute_dtype``."""
    y = torch.matmul(x.to(compute_dtype).to(torch.float32),
                     w.to(compute_dtype).to(torch.float32))
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(compute_dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up
