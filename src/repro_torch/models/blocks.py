"""Per-layer blocks (twin of ``repro.models.blocks``): pre-norm
attention (GQA or MLA) + pre-norm FFN (the ``cfg.act`` MLP, SwiGLU or
GELU, or MoE) for the attention families, and pre-norm Mamba2 (``ssd``)
for the ssm family, with rmsnorm or layernorm (``cfg.norm``).
DeepSeek-V2's leading dense layers are MLA blocks with a dense FFN
(``dense_block_schema``, ``dense_ffn=True``). The training form
``block_apply`` and the one-shot prefill ``block_prefill`` cover every
layer kind."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common, mla, mlp, moe, ssd
from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import PagedLayout


def stack_schema(schema: dict, n: int) -> dict:
    """Prepend a stacked layer axis to every leaf of a block schema."""
    out = {}
    for k, v in schema.items():
        if isinstance(v, ParamSpec):
            out[k] = dataclasses.replace(
                v, shape=(n,) + v.shape,
                logical_axes=("layers",) + v.logical_axes)
        else:
            out[k] = stack_schema(v, n)
    return out


def _attn_schema(cfg: ModelConfig) -> dict:
    return (mla.mla_schema(cfg.d_model, cfg.mla) if cfg.mla is not None
            else attn.gqa_schema(cfg.d_model, cfg.attn()))


def _recurrent(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def block_schema(cfg: ModelConfig) -> dict:
    """Schema of ONE layer of the main stack."""
    if _recurrent(cfg):
        return {"norm": common.norm_schema(cfg.d_model, cfg.norm),
                "mixer": ssd.mamba2_schema(cfg.d_model, cfg.ssm)}
    return {"ln_attn": common.norm_schema(cfg.d_model, cfg.norm),
            "ln_mlp": common.norm_schema(cfg.d_model, cfg.norm),
            "attn": _attn_schema(cfg),
            "ffn": (moe.moe_schema(cfg.d_model, cfg.moe) if cfg.moe
                    is not None else mlp.mlp_schema(cfg.d_model, cfg.d_ff,
                                                   act=cfg.act))}


def dense_block_schema(cfg: ModelConfig, d_ff: int) -> dict:
    """A dense (non-MoE) block: DeepSeek-V2's first_k_dense layers."""
    return {"ln_attn": common.norm_schema(cfg.d_model, cfg.norm),
            "ln_mlp": common.norm_schema(cfg.d_model, cfg.norm),
            "attn": _attn_schema(cfg),
            "ffn": mlp.mlp_schema(cfg.d_model, d_ff, act=cfg.act)}


def _ssm_cfg(cfg: ModelConfig) -> ssd.SSMConfig:
    """The mixer config with the model-level ``kahan_ssm_state`` knob
    threaded through (the forms that scan; decode has no carry)."""
    return cfg.ssm._replace(kahan_state=cfg.kahan_ssm_state)


def _mla_cfg(cfg: ModelConfig) -> mla.MLAConfig:
    """MLA config with the model-level ``kv_dtype`` threaded through."""
    return cfg.mla._replace(kv_dtype=cfg.kv_dtype)


def _ffn_residual(p: dict, h: torch.Tensor, cfg: ModelConfig,
                  dense_ffn: bool) -> torch.Tensor:
    x = common.apply_norm(h, p["ln_mlp"], cfg.norm)
    if cfg.moe is not None and not dense_ffn:
        y, _ = moe.moe_forward(p["ffn"], x, cfg.moe)
        return h + y
    return h + mlp.mlp_forward(p["ffn"], x, act=cfg.act)


# the reference's per-layer aux outputs (MoE losses); a dense layer's are 0
AUX_KEYS = ("moe_load_balance", "moe_z_loss", "moe_drop_fraction")


def check_trainable(cfg: ModelConfig) -> None:
    """Every family the port serves also trains, as in the reference
    (which refuses none of them): dense and vlm GQA decoders, MoE layers
    with GQA or MLA attention, Mamba2 stacks, the hybrid and the
    encoder-decoder. Raises only what ``check_supported`` refuses."""
    cfg.check_supported()


def block_apply(p: dict, h: torch.Tensor, cfg: ModelConfig, *,
                dense_ffn: bool = False) -> tuple[torch.Tensor, dict]:
    """Full-sequence (training) forward of one layer, h [B, L, d] ->
    (h, aux): GQA or MLA attention, then the ``cfg.act`` MLP or the MoE
    layer (whose aux losses it returns; a dense layer's are 0), or a Mamba2
    layer. A DeepSeek-V2 ``dense_ffn`` layer is MLA with a dense MLP.
    The training forward never quantizes (MLA takes ``cfg.mla`` as it
    stands, not ``kv_dtype``)."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if _recurrent(cfg):
        h = h + ssd.mamba2_forward(
            p["mixer"], common.apply_norm(h, p["norm"], cfg.norm),
            _ssm_cfg(cfg))
        return h, dict.fromkeys(AUX_KEYS, zero)
    x = common.apply_norm(h, p["ln_attn"], cfg.norm)
    if cfg.mla is not None:
        h = h + mla.mla_forward(p["attn"], x, cfg.mla)
    else:
        h = h + attn.gqa_forward(p["attn"], x, cfg.attn())
    x = common.apply_norm(h, p["ln_mlp"], cfg.norm)
    if cfg.moe is not None and not dense_ffn:
        y, aux = moe.moe_forward(p["ffn"], x, cfg.moe)
        return h + y, aux
    h = h + mlp.mlp_forward(p["ffn"], x, act=cfg.act)
    return h, dict.fromkeys(AUX_KEYS, zero)


def block_prefill(p: dict, h: torch.Tensor, cfg: ModelConfig,
                  layout: PagedLayout, *, dense_ffn: bool = False
                  ) -> tuple[torch.Tensor, dict]:
    """One-shot prefill of one layer (h [B, L, d]): the forward, and this
    layer's fresh decode cache (block-paged K/V or latents with identity
    tables, or the Mamba2 state and conv window)."""
    if _recurrent(cfg):
        x = common.apply_norm(h, p["norm"], cfg.norm)
        y, cache = ssd.mamba2_forward(p["mixer"], x, _ssm_cfg(cfg),
                                      return_state=True)
        return h + y, cache
    x = common.apply_norm(h, p["ln_attn"], cfg.norm)
    if cfg.mla is not None:
        y, cache = mla.mla_prefill(p["attn"], x, _mla_cfg(cfg), layout)
    else:
        y, cache = attn.gqa_prefill(p["attn"], x, cfg.attn(), layout)
    return _ffn_residual(p, h + y, cfg, dense_ffn), cache


def block_prefill_chunk(p: dict, h: torch.Tensor, cfg: ModelConfig,
                        cache: dict, slot: int, pos0: int, *,
                        dense_ffn: bool = False) -> torch.Tensor:
    """Prefill one chunk of ONE sequence (h [1, C, d]) through one layer;
    the layer's cache view is updated in place (a Mamba2 layer continues
    the conv window and SSD state of batch slot ``slot``)."""
    if _recurrent(cfg):
        x = common.apply_norm(h, p["norm"], cfg.norm)
        one = {k: v[slot:slot + 1] for k, v in cache.items()}
        y, new = ssd.mamba2_prefill_chunk(p["mixer"], x, _ssm_cfg(cfg), one)
        for k, v in new.items():
            one[k].copy_(v)
        return h + y
    x = common.apply_norm(h, p["ln_attn"], cfg.norm)
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
    if _recurrent(cfg):
        x = common.apply_norm(h, p["norm"], cfg.norm)
        return h + ssd.mamba2_decode(p["mixer"], x, cfg.ssm, cache)
    x = common.apply_norm(h, p["ln_attn"], cfg.norm)
    if cfg.mla is not None:
        y = mla.mla_decode(p["attn"], x, _mla_cfg(cfg), cache)
    else:
        y = attn.gqa_decode(p["attn"], x, cfg.attn(), cache)
    return _ffn_residual(p, h + y, cfg, dense_ffn)


def block_verify_chunk(p: dict, h: torch.Tensor, cfg: ModelConfig,
                       cache: dict, slots: torch.Tensor,
                       pos0s: torch.Tensor, *,
                       dense_ffn: bool = False) -> torch.Tensor:
    """Speculative verify of one layer: a [S, C, d] window, each row
    appended + attended at its own slot and offset in one pass."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            "speculative verify needs a rollback-able paged KV cache; "
            f"the {cfg.family!r} family carries recurrent state")
    x = common.apply_norm(h, p["ln_attn"], cfg.norm)
    if cfg.mla is not None:
        y = mla.mla_verify_chunk(p["attn"], x, _mla_cfg(cfg), cache, slots,
                                 pos0s)
    else:
        y = attn.gqa_verify_chunk(p["attn"], x, cfg.attn(), cache, slots,
                                  pos0s)
    return _ffn_residual(p, h + y, cfg, dense_ffn)


def block_cache_spec(cfg: ModelConfig, batch: int, layout: PagedLayout,
                     num_blocks: int | None = None) -> dict:
    if _recurrent(cfg):
        return ssd.mamba2_cache_spec(batch, cfg.ssm)
    if cfg.mla is not None:
        return mla.mla_cache_spec(batch, layout, _mla_cfg(cfg),
                                  num_blocks=num_blocks)
    return attn.gqa_cache_spec(batch, layout, cfg.attn(),
                               num_blocks=num_blocks)
