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


def _shard_residual(h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The residual stream entering a layer (``common.residual``); under
    ``cfg.sp_residual`` laid out over its sequence too (``act_res_seq``:
    the model axis), the per-layer input that remat keeps."""
    if not cfg.sp_residual:
        return common.residual(h)
    from repro_torch.distributed.sharding import shard_act
    return shard_act(h, "act_batch", "act_res_seq", None)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a tensor (a DTensor's local tensor)."""
    return t if type(t) is torch.Tensor else t.to_local()


def _ffn_hidden(p: dict, h: torch.Tensor, act: str, moe_cfg=None) -> tuple:
    """The (rows, columns) of an FFN's hidden activations on this rank
    for the layer input h [B, L, d] (``attention.layer_bytes``): h's
    local tokens by the MLP's local hidden width, or a MoE layer's
    expert rows (its local experts' buckets) by the expert width, and
    its shared experts' like an MLP's."""
    tokens = _local(h).numel() // h.shape[-1]
    if moe_cfg is not None:
        rows = (_local(p["w_gate_up"]).shape[0]
                * moe.capacity(h.shape[0] * h.shape[1], moe_cfg))
        out = ((rows, moe_cfg.d_ff),)
        if moe_cfg.num_shared:
            out += ((tokens,
                     _local(p["shared"]["w_gate_up"]).shape[-1] // 2),)
        return out
    if act == "swiglu":
        return ((tokens, _local(p["w_gate_up"]).shape[-1] // 2),)
    return ((tokens, _local(p["w_up"]).shape[-1]),)


def _residual_add(h: torch.Tensor, y: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """h + y, a sublayer's output y added to the residual h. Under
    ``cfg.sp_residual`` y is laid out as h is first (over batch and
    sequence: each rank keeps its sequence shard of y), so that the sum
    stays split and y's gradient comes back in y's own layout: left to
    DTensor, it would come back split over the sequence too, and the
    sublayer's backward would flatten it into rows split over two mesh
    dims (a strided shard)."""
    if cfg.sp_residual:
        from repro_torch.distributed.sharding import lay_out
        y = lay_out(y, "act_batch", "act_res_seq", None)
    return h + y


def _normed(h: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """The norm of h as a layer's products take it. Under
    ``cfg.sp_residual`` the norm runs on h's sequence shards and its
    output is gathered over the sequence (laid out over the batch alone),
    as sequence parallelism gathers before its column-parallel products:
    a product of [B, L, d] rows split over batch and sequence would
    flatten them into rows split over two mesh dims at once, a strided
    shard that the products' weights (N over the model axis) cannot
    meet without gathering it anyway."""
    x = common.apply_norm(h, p, cfg.norm)
    if not cfg.sp_residual:
        return x
    from repro_torch.distributed.sharding import lay_out
    return lay_out(x, "act_batch", "act_seq", "act_embed")


def block_apply(p: dict, h: torch.Tensor, cfg: ModelConfig, *,
                dense_ffn: bool = False) -> tuple[torch.Tensor, dict]:
    """Full-sequence (training) forward of one layer, h [B, L, d] ->
    (h, aux): GQA or MLA attention, then the ``cfg.act`` MLP or the MoE
    layer (whose aux losses it returns; a dense layer's are 0), or a Mamba2
    layer. A DeepSeek-V2 ``dense_ffn`` layer is MLA with a dense MLP.
    The training forward never quantizes (MLA takes ``cfg.mla`` as it
    stands, not ``kv_dtype``)."""
    h = _shard_residual(h, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if _recurrent(cfg):
        y = ssd.mamba2_forward(p["mixer"], _normed(h, p["norm"], cfg),
                               _ssm_cfg(cfg))
        return _residual_add(h, y, cfg), dict.fromkeys(AUX_KEYS, zero)
    x = _normed(h, p["ln_attn"], cfg)
    moe_ffn = cfg.moe is not None and not dense_ffn
    with attn.beside_layer(attn.layer_bytes(h, _ffn_hidden(
            p["ffn"], h, cfg.act, cfg.moe if moe_ffn else None))):
        if cfg.mla is not None:
            y = mla.mla_forward(p["attn"], x, cfg.mla)
        else:
            y = attn.gqa_forward(p["attn"], x, cfg.attn())
    h = _residual_add(h, y, cfg)
    x = _normed(h, p["ln_mlp"], cfg)
    if moe_ffn:
        y, aux = moe.moe_forward(p["ffn"], x, cfg.moe)
        return _residual_add(h, y, cfg), aux
    y = mlp.mlp_forward(p["ffn"], x, act=cfg.act)
    return _residual_add(h, y, cfg), dict.fromkeys(AUX_KEYS, zero)


def block_prefill(p: dict, h: torch.Tensor, cfg: ModelConfig,
                  layout: PagedLayout, *, dense_ffn: bool = False
                  ) -> tuple[torch.Tensor, dict]:
    """One-shot prefill of one layer (h [B, L, d]): the forward, and this
    layer's fresh decode cache (block-paged K/V or latents with identity
    tables, or the Mamba2 state and conv window)."""
    h = common.residual(h)
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
    h = common.residual(h)
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
