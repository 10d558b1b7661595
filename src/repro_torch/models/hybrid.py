"""Zamba2-style hybrid: a Mamba2 backbone and one weight-shared
attention + MLP block (twin of ``repro.models.hybrid``): the training
forms ``hybrid_forward`` / ``hybrid_loss`` and the one-shot serving
forms.

The backbone is ``n_seg`` segments of ``segment_len`` Mamba2 layers and
a tail of the rest; after each segment the SAME attention + MLP block
runs, with the segment's rank-r LoRA update folded into its q / k / v
weights (in f32, on every call, as the reference does). The decode cache
is ``{"mamba": {ssm, conv} [n_seg, seg, ...], "attn": one paged GQA
cache per block call [n_seg, ...], "tail": {ssm, conv} [tail, ...] or
None}``; ``hybrid_decode`` updates it IN PLACE (the port's convention)
through per-layer views. The logits are bf16 through ``common.dense``,
as the reference's (not the f32 serving head of ``models.lm``).

The shared block's q / k / v weights stay f32 in the parameter tree
(``hybrid_schema`` marks them ``keep_f32``): the fold adds the LoRA
product to the f32 weight before the product's bf16 rounding. As in the
reference, the shared block's pools are bf16 whatever ``kv_dtype`` says.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import common, mlp, ssd
from repro_torch.models.blocks import stack_schema
from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import PagedLayout


# the shared attention's weights that take each segment's LoRA update
_FOLDED = ("wq", "wk", "wv")


def _segments(cfg: ModelConfig) -> tuple[int, int, int]:
    seg = cfg.hybrid.segment_len
    n_seg = cfg.num_layers // seg
    return seg, n_seg, cfg.num_layers - n_seg * seg


def _shared_attn_cfg(cfg: ModelConfig) -> attn.AttnConfig:
    hy = cfg.hybrid
    return attn.AttnConfig(
        num_heads=hy.num_attn_heads, num_kv_heads=hy.num_kv_heads,
        head_dim=cfg.d_model // hy.num_attn_heads, rope_theta=cfg.rope_theta,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        kahan_acc=cfg.kahan_attn, causal=True)


def hybrid_schema(cfg: ModelConfig) -> dict:
    seg, n_seg, tail = _segments(cfg)
    hy = cfg.hybrid
    acfg = _shared_attn_cfg(cfg)
    qkv_out = hy.num_attn_heads * acfg.head_dim
    kv_out = hy.num_kv_heads * acfg.head_dim
    r = hy.lora_rank
    mamba_block = {"norm": common.norm_schema(cfg.d_model, cfg.norm),
                   "mixer": ssd.mamba2_schema(cfg.d_model, cfg.ssm)}
    shared_attn = attn.gqa_schema(cfg.d_model, acfg)
    for name in _FOLDED:
        shared_attn[name] = dataclasses.replace(shared_attn[name],
                                                keep_f32=True)
    s: dict = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "final_norm": common.norm_schema(cfg.d_model, cfg.norm),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                             init="fan_in"),
        "mamba_blocks": stack_schema(mamba_block, n_seg * seg),
        "shared": {
            "ln_attn": common.norm_schema(cfg.d_model, cfg.norm),
            "attn": shared_attn,
            "ln_mlp": common.norm_schema(cfg.d_model, cfg.norm),
            "ffn": mlp.mlp_schema(cfg.d_model, hy.shared_d_ff, act=cfg.act),
        },
        "lora": {
            "a_q": ParamSpec((n_seg, cfg.d_model, r), ("layers", "embed", None),
                             init="fan_in"),
            "b_q": ParamSpec((n_seg, r, qkv_out), ("layers", None, "q_heads"),
                             init="zeros"),
            "a_k": ParamSpec((n_seg, cfg.d_model, r), ("layers", "embed", None),
                             init="fan_in"),
            "b_k": ParamSpec((n_seg, r, kv_out), ("layers", None, "kv_heads"),
                             init="zeros"),
            "a_v": ParamSpec((n_seg, cfg.d_model, r), ("layers", "embed", None),
                             init="fan_in"),
            "b_v": ParamSpec((n_seg, r, kv_out), ("layers", None, "kv_heads"),
                             init="zeros"),
        },
    }
    if tail:
        s["mamba_tail"] = stack_schema(mamba_block, tail)
    return s


def _lora_params(p: dict, seg_idx: int) -> dict:
    """The shared attention's weights with segment ``seg_idx``'s LoRA
    folded in: W + A B in f32. ``dense`` rounds its weight to bf16, so
    the folded weight is rounded to bf16 here once: the same bits."""
    lora = p["lora"]
    eff = dict(p["shared"]["attn"])
    if any(eff[name].dtype != torch.float32 for name in _FOLDED):
        raise ValueError("the shared block's wq / wk / wv must be held f32 "
                         "for the LoRA fold (build or bridge the tree with "
                         "the hybrid's schema)")
    for name, a, b in zip(_FOLDED, ("a_q", "a_k", "a_v"),
                          ("b_q", "b_k", "b_v")):
        delta = torch.matmul(lora[a][seg_idx].to(torch.float32),
                             lora[b][seg_idx].to(torch.float32))
        eff[name] = (eff[name] + delta).to(torch.bfloat16)
    return eff


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return common.embed_tokens(params["embed"], tokens)


def _mamba_layers(params: dict, seg: int, n_seg: int):
    """(segment, index in segment, layer params) over the backbone, then
    (None, index in tail, layer params) over the tail."""
    for j, lp in enumerate(params["mamba_blocks"]):
        yield j // seg, j % seg, lp
    for i, lp in enumerate(params.get("mamba_tail", [])):
        yield None, i, lp


def _shared_mlp(params: dict, h: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    x = common.apply_norm(h, params["shared"]["ln_mlp"], cfg.norm)
    return h + mlp.mlp_forward(params["shared"]["ffn"], x, act=cfg.act)


def _stack(trees: list) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _shared_block(params: dict, h: torch.Tensor, cfg: ModelConfig,
                  seg_idx: int) -> torch.Tensor:
    """Training form of the shared attention + MLP block after segment
    ``seg_idx``: full-sequence causal GQA with the segment's LoRA folded
    into q / k / v."""
    h = common.residual(h)
    x = common.apply_norm(h, params["shared"]["ln_attn"], cfg.norm)
    h = h + attn.gqa_forward(_lora_params(params, seg_idx), x,
                             _shared_attn_cfg(cfg))
    return _shared_mlp(params, h, cfg)


def _mamba_layer(lp: dict, h: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    h = common.residual(h)
    x = common.apply_norm(h, lp["norm"], cfg.norm)
    return h + ssd.mamba2_forward(
        lp["mixer"], x, cfg.ssm._replace(kahan_state=cfg.kahan_ssm_state))


def _mamba_stack(layers: list, h: torch.Tensor, cfg: ModelConfig, *,
                 remat: bool) -> torch.Tensor:
    """The Mamba2 layers of one segment (or the tail) in order; under
    ``remat`` each layer is recomputed in backward
    (``torch.utils.checkpoint``, saving nothing inside it: the
    reference's "nothing" policy), which changes no bit."""
    for lp in layers:
        h = (checkpoint(_mamba_layer, lp, h, cfg, use_reentrant=False)
             if remat else _mamba_layer(lp, h, cfg))
    return h


def hybrid_forward(params: dict, batch: dict, cfg: ModelConfig
                   ) -> tuple[torch.Tensor, dict]:
    """Full-sequence training forward: (bf16 logits [B, L, V], {})."""
    seg, n_seg, tail = _segments(cfg)
    h = _embed(params, batch["tokens"])
    blocks = params["mamba_blocks"]
    for s in range(n_seg):
        h = _mamba_stack(blocks[s * seg:(s + 1) * seg], h, cfg,
                         remat=cfg.remat)
        h = _shared_block(params, h, cfg, s)
    if tail:
        h = _mamba_stack(params["mamba_tail"], h, cfg, remat=cfg.remat)
    h = common.apply_norm(common.residual(h), params["final_norm"],
                          cfg.norm)
    return common.dense(h, params["lm_head"]), {}


def hybrid_loss(params: dict, batch: dict, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """Weighted causal-LM cross entropy in f32: (loss, {ce_loss,
    tokens}), the reference's metrics (no MoE aux keys)."""
    logits, _ = hybrid_forward(params, batch, cfg)
    return common.weighted_ce(logits, batch)


def hybrid_prefill(params: dict, batch: dict, cfg: ModelConfig,
                   layout: PagedLayout) -> tuple[torch.Tensor, dict]:
    """One-shot prefill of ``batch["tokens"]`` [B, L]: (last position's
    bf16 logits [B, V], fresh caches ``{mamba, attn, tail}``)."""
    seg, n_seg, tail = _segments(cfg)
    acfg = _shared_attn_cfg(cfg)
    h = _embed(params, batch["tokens"])
    mamba, tail_c, attn_c = [], [], []
    for s, i, lp in _mamba_layers(params, seg, n_seg):
        x = common.apply_norm(h, lp["norm"], cfg.norm)
        y, cache = ssd.mamba2_forward(lp["mixer"], x, cfg.ssm,
                                      return_state=True)
        h = h + y
        (tail_c if s is None else mamba).append(cache)
        if s is not None and i == seg - 1:
            x = common.apply_norm(h, params["shared"]["ln_attn"], cfg.norm)
            y, kv = attn.gqa_prefill(_lora_params(params, s), x, acfg,
                                     layout)
            h = _shared_mlp(params, h + y, cfg)
            attn_c.append(kv)
    h = common.apply_norm(common.residual(h), params["final_norm"],
                          cfg.norm)
    logits = common.dense(h[:, -1], params["lm_head"])
    caches = {"mamba": {k: v.reshape((n_seg, seg) + v.shape[1:])
                        for k, v in _stack(mamba).items()},
              "attn": _stack(attn_c),
              "tail": _stack(tail_c) if tail else None}
    return logits, caches


def hybrid_decode(params: dict, tokens: torch.Tensor, caches: dict,
                  cfg: ModelConfig) -> torch.Tensor:
    """One decode step for every slot (tokens [B, 1]): bf16 logits
    [B, V]; ``caches`` update in place (each Mamba2 layer's state and
    conv window, each block call's paged K/V and ``len``)."""
    seg, n_seg, _ = _segments(cfg)
    acfg = _shared_attn_cfg(cfg)
    h = _embed(params, tokens)
    for s, i, lp in _mamba_layers(params, seg, n_seg):
        view = ({k: v[i] for k, v in caches["tail"].items()} if s is None
                else {k: v[s, i] for k, v in caches["mamba"].items()})
        x = common.apply_norm(h, lp["norm"], cfg.norm)
        h = h + ssd.mamba2_decode(lp["mixer"], x, cfg.ssm, view)
        if s is not None and i == seg - 1:
            kv = {k: v[s] for k, v in caches["attn"].items()}
            x = common.apply_norm(h, params["shared"]["ln_attn"], cfg.norm)
            h = h + attn.gqa_decode(_lora_params(params, s), x, acfg, kv)
            h = _shared_mlp(params, h, cfg)
    h = common.apply_norm(common.residual(h), params["final_norm"],
                          cfg.norm)
    return common.dense(h[:, -1], params["lm_head"])


def hybrid_cache_specs(cfg: ModelConfig, batch: int, layout: PagedLayout,
                       num_blocks: int | None = None) -> dict:
    """{"mamba": {leaf: ((n_seg, seg, ...), dtype)}, "attn": {leaf:
    ((n_seg, ...), dtype)}, "tail": {leaf: ((tail, ...), dtype)} or
    None}."""
    seg, n_seg, tail = _segments(cfg)
    mamba = ssd.mamba2_cache_spec(batch, cfg.ssm)
    kv = attn.gqa_cache_spec(batch, layout, _shared_attn_cfg(cfg),
                             num_blocks=num_blocks)

    def stack(spec: dict, *dims) -> dict:
        return {k: (dims + shape, dtype) for k, (shape, dtype) in spec.items()}

    return {"mamba": stack(mamba, n_seg, seg), "attn": stack(kv, n_seg),
            "tail": stack(mamba, tail) if tail else None}
