"""Parameter schemas and shared layer primitives (twin of
``repro.models.common``).

Parameters are plain nested dicts of tensors built from a declarative
schema, in the reference's dtypes (f32), except the weights that only
ever feed ``dense`` (or the MoE expert products) at ``compute_dtype`` bf16
(``BF16_WEIGHTS``): ``hold_weights_bf16`` keeps those as bf16 from load
time. ``dense`` rounds its operands to bf16 anyway, and rounding is
idempotent, so no product changes.

``dense`` computes what the reference's bf16 einsum with f32
accumulation computes: bf16 operands, f32 products and sums, the bias
added in f32, one rounding of the result to ``compute_dtype``. On the
card that is a bf16 tensor-core GEMM with an f32 result
(``torch.mm(..., out_dtype=torch.float32)``); PyTorch's CPU backend has
no such op, so on the CPU both operands are widened to f32 (bf16 x bf16
products are exact in f32).
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
    # in place: a full-width MoE leaf is 20 GB, and a scaled copy would
    # double it
    return x.mul_(scale).to(spec.dtype)


# Weights that only ever feed ``dense`` or the MoE expert products at
# compute_dtype=bf16 (attention q/k/v/o, the MLP, the MoE router and
# experts, the MLA projections wq_a / wq_b / wkv_a / wo). The reference
# keeps norms, embeddings, the LM head (an f32 product), biases and the
# absorbed MLA weights wk_b / wv_b at f32, and so does the port.
BF16_WEIGHTS = frozenset({"wq", "wk", "wv", "wo", "w_gate_up", "w_down",
                          "router", "wq_a", "wq_b", "wkv_a"})


def init_params(schema: dict, generator: torch.Generator,
                device, *, hold_bf16: bool = False) -> dict:
    """Materialize a parameter tree from a schema, leaves drawn in sorted
    path order from ``generator`` (which must live on ``device``).
    ``hold_bf16`` rounds each ``BF16_WEIGHTS`` leaf to bf16 as it is
    drawn (the draws do not change), so the f32 tree never exists whole."""
    tree: dict = {}
    for path, spec in _flatten_schema(schema):
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        leaf = _init_leaf(spec, generator, device)
        if hold_bf16 and parts[-1] in BF16_WEIGHTS:
            leaf = leaf.to(torch.bfloat16)
        node[parts[-1]] = leaf
    return tree


def hold_weights_bf16(tree):
    """The tree (nested dicts and per-layer lists) with every
    ``BF16_WEIGHTS`` leaf rounded to bf16; other leaves, and leaves
    already bf16, are passed through as they are."""
    if isinstance(tree, dict):
        return {k: (v.to(torch.bfloat16) if k in BF16_WEIGHTS
                    and isinstance(v, torch.Tensor)
                    else hold_weights_bf16(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [hold_weights_bf16(v) for v in tree]
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
    accumulation, bias added in f32, one rounding to ``compute_dtype``.
    On the card a bf16 ``compute_dtype`` runs one tensor-core GEMM with an
    f32 result; elsewhere the rounded operands are widened to f32."""
    if x.is_cuda and compute_dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]).to(compute_dtype),
                     w.to(compute_dtype), out_dtype=torch.float32)
        y = y.reshape(*x.shape[:-1], w.shape[-1])
    else:
        y = torch.matmul(x.to(compute_dtype).to(torch.float32),
                         w.to(compute_dtype).to(torch.float32))
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(compute_dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up
