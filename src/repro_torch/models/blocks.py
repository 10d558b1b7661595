"""Per-layer decoder blocks (the attention-family paths of
``repro.models.blocks``): pre-norm attention (GQA or MLA) + pre-norm FFN
(SwiGLU MLP, or MoE). DeepSeek-V2's leading dense layers are MLA blocks
with a dense FFN (``dense_block_schema``, ``dense_ffn=True``)."""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common, mla, mlp, moe
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


def _attn_schema(cfg: ModelConfig) -> dict:
    return (mla.mla_schema(cfg.d_model, cfg.mla) if cfg.mla is not None
            else attn.gqa_schema(cfg.d_model, cfg.attn()))


def block_schema(cfg: ModelConfig) -> dict:
    """Schema of ONE layer of the main stack."""
    return {"ln_attn": common.norm_schema(cfg.d_model),
            "ln_mlp": common.norm_schema(cfg.d_model),
            "attn": _attn_schema(cfg),
            "ffn": (moe.moe_schema(cfg.d_model, cfg.moe) if cfg.moe
                    is not None else mlp.mlp_schema(cfg.d_model, cfg.d_ff))}


def dense_block_schema(cfg: ModelConfig, d_ff: int) -> dict:
    """A dense (non-MoE) block: DeepSeek-V2's first_k_dense layers."""
    return {"ln_attn": common.norm_schema(cfg.d_model),
            "ln_mlp": common.norm_schema(cfg.d_model),
            "attn": _attn_schema(cfg),
            "ffn": mlp.mlp_schema(cfg.d_model, d_ff)}


def _mla_cfg(cfg: ModelConfig) -> mla.MLAConfig:
    """MLA config with the model-level ``kv_dtype`` threaded through."""
    return cfg.mla._replace(kv_dtype=cfg.kv_dtype)


def _ffn_residual(p: dict, h: torch.Tensor, cfg: ModelConfig,
                  dense_ffn: bool) -> torch.Tensor:
    x = common.rms_norm(h, p["ln_mlp"]["scale"])
    if cfg.moe is not None and not dense_ffn:
        y, _ = moe.moe_forward(p["ffn"], x, cfg.moe)
        return h + y
    return h + mlp.mlp_forward(p["ffn"], x)


def block_prefill_chunk(p: dict, h: torch.Tensor, cfg: ModelConfig,
                        cache: dict, slot: int, pos0: int, *,
                        dense_ffn: bool = False) -> torch.Tensor:
    """Prefill one chunk of ONE sequence (h [1, C, d]) through one layer;
    the layer's cache view is updated in place."""
    x = common.rms_norm(h, p["ln_attn"]["scale"])
    if cfg.mla is not None:
        y = mla.mla_prefill_chunk(p["attn"], x, _mla_cfg(cfg), cache, slot,
                                  pos0)
    else:
        y = attn.gqa_prefill_chunk(p["attn"], x, cfg.attn(), cache, slot,
                                   pos0)
    return _ffn_residual(p, h + y, cfg, dense_ffn)


def block_decode(p: dict, h: torch.Tensor, cfg: ModelConfig, cache: dict,
                 *, dense_ffn: bool = False) -> torch.Tensor:
    """One-token step (h [B, 1, d]) against this layer's cache view."""
    x = common.rms_norm(h, p["ln_attn"]["scale"])
    if cfg.mla is not None:
        y = mla.mla_decode(p["attn"], x, _mla_cfg(cfg), cache)
    else:
        y = attn.gqa_decode(p["attn"], x, cfg.attn(), cache)
    return _ffn_residual(p, h + y, cfg, dense_ffn)


def block_cache_spec(cfg: ModelConfig, batch: int, layout: PagedLayout,
                     num_blocks: int | None = None) -> dict:
    if cfg.mla is not None:
        return mla.mla_cache_spec(batch, layout, _mla_cfg(cfg),
                                  num_blocks=num_blocks)
    return attn.gqa_cache_spec(batch, layout, cfg.attn(),
                               num_blocks=num_blocks)
