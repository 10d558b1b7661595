"""Per-layer dense decoder block (the dense path of
``repro.models.blocks``): pre-norm GQA attention + pre-norm SwiGLU MLP."""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common, mlp
from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import PagedLayout


def stack_schema(schema: dict, n: int) -> dict:
    """Prepend a stacked layer axis to every leaf of a block schema."""
    out = {}
    for k, v in schema.items():
        if isinstance(v, ParamSpec):
            out[k] = ParamSpec((n,) + v.shape, init=v.init, scale=v.scale,
                               dtype=v.dtype)
        else:
            out[k] = stack_schema(v, n)
    return out


def block_schema(cfg: ModelConfig) -> dict:
    """Schema of ONE layer."""
    return {"ln_attn": common.norm_schema(cfg.d_model),
            "ln_mlp": common.norm_schema(cfg.d_model),
            "attn": attn.gqa_schema(cfg.d_model, cfg.attn()),
            "ffn": mlp.mlp_schema(cfg.d_model, cfg.d_ff)}


def _mlp_residual(p: dict, h: torch.Tensor) -> torch.Tensor:
    return h + mlp.mlp_forward(p["ffn"], common.rms_norm(h, p["ln_mlp"]
                                                         ["scale"]))


def block_prefill_chunk(p: dict, h: torch.Tensor, cfg: ModelConfig,
                        cache: dict, slot: int, pos0: int) -> torch.Tensor:
    """Prefill one chunk of ONE sequence (h [1, C, d]) through one layer;
    the layer's cache view is updated in place."""
    x = common.rms_norm(h, p["ln_attn"]["scale"])
    h = h + attn.gqa_prefill_chunk(p["attn"], x, cfg.attn(), cache, slot,
                                   pos0)
    return _mlp_residual(p, h)


def block_decode(p: dict, h: torch.Tensor, cfg: ModelConfig,
                 cache: dict) -> torch.Tensor:
    """One-token step (h [B, 1, d]) against this layer's cache view."""
    x = common.rms_norm(h, p["ln_attn"]["scale"])
    h = h + attn.gqa_decode(p["attn"], x, cfg.attn(), cache)
    return _mlp_residual(p, h)


def block_cache_spec(cfg: ModelConfig, batch: int, layout: PagedLayout,
                     num_blocks: int | None = None) -> dict:
    return attn.gqa_cache_spec(batch, layout, cfg.attn(),
                               num_blocks=num_blocks)
