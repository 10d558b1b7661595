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
(``torch.mm(..., out_dtype=torch.float32)``, with a backward of the same
form for training); PyTorch's CPU backend has no such op, so on the CPU
both operands are widened to f32 (bf16 x bf16 products are exact in
f32).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

# the reference's norms: f32 RMS / layer norm of each row, rounded to x's
# dtype; on the card, when autograd records nothing, the row-norm kernel
# (each row's bits the same at any number of rows), else the plain twin
from repro_torch.kernels import invariant_gemm
from repro_torch.kernels.row_norm import layer_norm, rms_norm  # noqa: F401


@dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor: its shape, the *logical* axis
    of each dimension (mapped to mesh axes by
    ``repro_torch.distributed.sharding``), its initializer."""
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...] = ()
    init: str = "normal"          # normal | zeros | ones | fan_in
    scale: float = 0.02
    dtype: torch.dtype = torch.float32
    # a ``BF16_WEIGHTS`` leaf that is changed in f32 before its product
    # (the hybrid's LoRA-folded q / k / v) keeps its f32 bits when held
    keep_f32: bool = False


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


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def abstract_params(schema: dict) -> dict:
    """The parameter tree as meta tensors: each leaf's shape and dtype,
    no memory (the reference's ``ShapeDtypeStruct`` tree)."""
    return _unflatten({p: torch.empty(s.shape, dtype=s.dtype, device="meta")
                       for p, s in _flatten_schema(schema)})


def logical_axes_tree(schema: dict) -> dict:
    """A tree of the parameters' structure holding each leaf's tuple of
    logical axes."""
    return _unflatten({p: s.logical_axes for p, s in _flatten_schema(schema)})


def count_params(schema: dict) -> int:
    return sum(math.prod(s.shape) for _, s in _flatten_schema(schema))


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
# experts, the MLA projections wq_a / wq_b / wkv_a / wo, the Mamba2
# mixer's in_proj / out_proj). The reference
# keeps norms, embeddings, the LM head (an f32 product), biases and the
# absorbed MLA weights wk_b / wv_b at f32, and so does the port.
BF16_WEIGHTS = frozenset({"wq", "wk", "wv", "wo", "w_gate_up", "w_down",
                          "w_up", "router", "wq_a", "wq_b", "wkv_a",
                          "in_proj", "out_proj"})


_BY_NAME = ParamSpec(())        # a leaf held by its name alone


def _held_bf16(name: str, spec: ParamSpec) -> bool:
    return name in BF16_WEIGHTS and not spec.keep_f32


def init_params(schema: dict, generator: torch.Generator,
                device, *, hold_bf16: bool = False) -> dict:
    """Materialize a parameter tree from a schema, leaves drawn in sorted
    path order from ``generator`` (which must live on ``device``).
    ``hold_bf16`` rounds each ``BF16_WEIGHTS`` leaf (not ``keep_f32``)
    to bf16 as it is drawn (the draws do not change), so the f32 tree
    never exists whole."""
    flat = {}
    for path, spec in _flatten_schema(schema):
        leaf = _init_leaf(spec, generator, device)
        if hold_bf16 and _held_bf16(path.rsplit("/", 1)[-1], spec):
            leaf = leaf.to(torch.bfloat16)
        flat[path] = leaf
    return _unflatten(flat)


def hold_weights_bf16(tree: dict, schema: dict | None = None) -> dict:
    """``tree`` (layers stacked) with every ``BF16_WEIGHTS`` leaf rounded
    to bf16, except those that ``schema`` (the tree's own, when given)
    marks ``keep_f32``; other leaves, and leaves already bf16, pass
    through."""
    out = {}
    for k, v in tree.items():
        spec = None if schema is None else schema[k]
        if isinstance(v, torch.Tensor):
            held = _held_bf16(k, spec or _BY_NAME)
            out[k] = v.to(torch.bfloat16) if held else v
        else:
            out[k] = hold_weights_bf16(v, spec)
    return out


# ------------------------------------------------------------ primitives ---

def apply_norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def norm_schema(d: int, kind: str = "rmsnorm") -> dict:
    if kind == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), init="ones"),
                "bias": ParamSpec((d,), ("embed",), init="zeros")}
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


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


def sinusoidal_positions(length: int, dim: int,
                         device="cpu") -> torch.Tensor:
    """Whisper-style sinusoidal embeddings [length, dim] f32: sin of
    position x inverse timescale in the first half, cos in the second."""
    log_timescale = math.log(10000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2,
                                                  dtype=torch.float32,
                                                  device=device))
    scaled = (torch.arange(length, dtype=torch.float32, device=device)
              [:, None] * inv[None, :])
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ w (+ b): operands rounded to ``compute_dtype``, f32
    accumulation, bias added in f32, one rounding to ``compute_dtype``.
    A bf16 ``compute_dtype`` goes through ``invariant_gemm.product``: on
    the card the M-invariant kernel when autograd records nothing for the
    call (every served product), cuBLAS's ``_Bf16Product`` under autograd
    (training); on the CPU its plain twin, the rounded operands widened
    to f32, which autograd differentiates as it stands."""
    if compute_dtype == torch.bfloat16:
        y = invariant_gemm.product(x, w)
    else:
        y = torch.matmul(x.to(compute_dtype).to(torch.float32),
                         w.to(compute_dtype).to(torch.float32))
    if type(y) is not torch.Tensor:        # a DTensor: sum partials in f32
        from repro_torch.distributed.sharding import reduce_partial
        y = reduce_partial(y)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(compute_dtype)


def weighted_ce(logits: torch.Tensor, batch: dict
                ) -> tuple[torch.Tensor, dict]:
    """The reference's weighted causal-LM cross entropy in f32 over
    ``batch["labels"]`` / ``batch["weights"]``: (loss, {ce_loss,
    tokens})."""
    labels = batch["labels"].to(torch.int64)
    weights = batch["weights"]
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels[..., None])[..., 0]
    loss = ((lse - ll) * weights).sum() / torch.clamp_min(weights.sum(), 1.0)
    return loss, {"ce_loss": loss, "tokens": weights.sum()}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: the tanh form."""
    return F.gelu(x, approximate="tanh")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up
