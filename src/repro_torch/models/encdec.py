"""Whisper-style encoder-decoder, the audio family (twin of
``repro.models.encdec``): the training forms ``encdec_forward`` /
``encdec_loss`` and the one-shot serving forms.

The conv / mel frontend is a stub, as in the reference: the batch's
``frames`` [B, enc_seq, d_model] are precomputed frame embeddings. The
encoder adds sinusoidal positions and runs pre-norm blocks of
bidirectional attention and GELU MLPs; the decoder adds learned
positions (indexed at each slot's length in decode) and runs causal
self-attention, cross-attention into the encoder memory and a GELU MLP,
ending in the tied head (bf16 logits through ``common.dense``).

The decode cache, per layer stacked over the decoder layers: ``self``,
a paged GQA cache whose pools take ``kv_dtype``, and ``cross_k`` /
``cross_v`` [L, B, enc_seq, Hkv, D], computed once at prefill, bf16 and
not pooled. ``encdec_decode`` updates ``self`` IN PLACE and reads the
cross K/V through ``attention.attend_cache`` (plain).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import merge_heads, split_heads
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp
from repro_torch.models.blocks import stack_schema
from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import PagedLayout


def _acfg(cfg: ModelConfig, *, causal: bool) -> attn.AttnConfig:
    # kv_dtype quantizes the decoder's paged self-K/V pools only; the
    # cross K/V are read-only, batch-local and bf16
    return attn.AttnConfig(
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rotary_fraction=0.0,   # whisper: no rope
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        kahan_acc=cfg.kahan_attn, causal=causal,
        kv_dtype=cfg.kv_dtype if causal else "bf16")


def encdec_schema(cfg: ModelConfig, max_dec_positions: int) -> dict:
    enc_block = {
        "ln_attn": common.norm_schema(cfg.d_model, cfg.norm),
        "attn": attn.gqa_schema(cfg.d_model, _acfg(cfg, causal=False)),
        "ln_mlp": common.norm_schema(cfg.d_model, cfg.norm),
        "ffn": mlp.mlp_schema(cfg.d_model, cfg.d_ff, act="gelu"),
    }
    dec_block = {
        "ln_self": common.norm_schema(cfg.d_model, cfg.norm),
        "self_attn": attn.gqa_schema(cfg.d_model, _acfg(cfg, causal=True)),
        "ln_cross": common.norm_schema(cfg.d_model, cfg.norm),
        "cross_attn": attn.gqa_schema(cfg.d_model, _acfg(cfg, causal=False)),
        "ln_mlp": common.norm_schema(cfg.d_model, cfg.norm),
        "ffn": mlp.mlp_schema(cfg.d_model, cfg.d_ff, act="gelu"),
    }
    return {
        "enc_layers": stack_schema(enc_block, cfg.encdec.enc_layers),
        "enc_norm": common.norm_schema(cfg.d_model, cfg.norm),
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "pos_embed": ParamSpec((max_dec_positions, cfg.d_model),
                               (None, "embed")),
        "dec_layers": stack_schema(dec_block, cfg.num_layers),
        "dec_norm": common.norm_schema(cfg.d_model, cfg.norm),
    }


def _memory_kv(p: dict, memory: torch.Tensor, cfg: ModelConfig):
    """The cross-attention's K / V [B, Lm, Hkv, D] of the encoder
    memory."""
    acfg = _acfg(cfg, causal=False)
    kv, dh = acfg.num_kv_heads, acfg.head_dim
    return (split_heads(common.dense(memory, p["wk"]), kv, dh),
            split_heads(common.dense(memory, p["wv"]), kv, dh))


def _cross_attention(p: dict, x: torch.Tensor, memory_kv,
                     cfg: ModelConfig) -> torch.Tensor:
    """x [B, Lq, d] against the precomputed memory K / V."""
    b, lq, _ = x.shape
    acfg = _acfg(cfg, causal=False)
    q = split_heads(common.dense(x, p["wq"]), acfg.num_heads, acfg.head_dim)
    k, v = memory_kv
    out = attn.flash_attention(q, k, v, causal=False, q_chunk=acfg.q_chunk,
                               kv_chunk=acfg.kv_chunk)
    return common.dense(merge_heads(out), p["wo"])


def _enc_layer(lp: dict, h: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    h = common.residual(h)
    x = common.apply_norm(h, lp["ln_attn"], cfg.norm)
    h = h + attn.gqa_forward(lp["attn"], x, _acfg(cfg, causal=False))
    x = common.apply_norm(h, lp["ln_mlp"], cfg.norm)
    return h + mlp.mlp_forward(lp["ffn"], x, act="gelu")


def encode(params: dict, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames [B, enc_seq, d_model] (the stub frontend's output) -> the
    encoder memory [B, enc_seq, d_model] bf16. Differentiable; under
    ``cfg.remat`` each layer is recomputed in backward (saving nothing
    inside it), which changes no bit."""
    h = frames.to(torch.bfloat16)
    h = h + common.sinusoidal_positions(h.shape[1], cfg.d_model,
                                        h.device).to(h.dtype)[None]
    for lp in params["enc_layers"]:
        h = (checkpoint(attn.keeping_loss_bytes(_enc_layer), lp, h, cfg,
                        use_reentrant=False)
             if cfg.remat else _enc_layer(lp, h, cfg))
    return common.apply_norm(h, params["enc_norm"], cfg.norm)


def _mlp_residual(lp: dict, h: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    x = common.apply_norm(h, lp["ln_mlp"], cfg.norm)
    return h + mlp.mlp_forward(lp["ffn"], x, act="gelu")


def _dec_layer(lp: dict, h: torch.Tensor, memory: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Training form of one decoder layer: causal self-attention over the
    sequence, cross-attention into the memory, the GELU MLP."""
    h = common.residual(h)
    x = common.apply_norm(h, lp["ln_self"], cfg.norm)
    h = h + attn.gqa_forward(lp["self_attn"], x, _acfg(cfg, causal=True))
    x = common.apply_norm(h, lp["ln_cross"], cfg.norm)
    mkv = _memory_kv(lp["cross_attn"], memory, cfg)
    h = h + _cross_attention(lp["cross_attn"], x, mkv, cfg)
    return _mlp_residual(lp, h, cfg)


def encdec_forward(params: dict, batch: dict, cfg: ModelConfig
                   ) -> tuple[torch.Tensor, dict]:
    """Teacher-forced training forward: encode ``batch["frames"]``, then
    the decoder over ``batch["tokens"]`` [B, L]: (bf16 logits [B, L, V]
    through the tied head, {})."""
    memory = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    l = tokens.shape[1]
    h = common.embed_tokens(params["embed"], tokens)
    h = h + params["pos_embed"][:l].to(h.dtype)[None]
    for lp in params["dec_layers"]:
        h = (checkpoint(attn.keeping_loss_bytes(_dec_layer), lp, h,
                        memory, cfg, use_reentrant=False)
             if cfg.remat else _dec_layer(lp, h, memory, cfg))
    h = common.apply_norm(h, params["dec_norm"], cfg.norm)
    return common.dense(h, params["embed"].T), {}


def encdec_loss(params: dict, batch: dict, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """Weighted cross entropy of the decoder's logits in f32: (loss,
    {ce_loss, tokens})."""
    logits, _ = encdec_forward(params, batch, cfg)
    return common.weighted_ce(logits, batch)


def _logits(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The tied head's bf16 logits [B, V] of the last position."""
    h = common.apply_norm(h, params["dec_norm"], cfg.norm)
    return common.dense(h[:, -1], params["embed"].T)


def encdec_prefill(params: dict, batch: dict, cfg: ModelConfig,
                   layout: PagedLayout) -> tuple[torch.Tensor, dict]:
    """Encode ``batch["frames"]``, then prefill the decoder on
    ``batch["tokens"]`` [B, L]: (last position's bf16 logits [B, V],
    fresh caches ``{self, cross_k, cross_v}``)."""
    memory = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    l = tokens.shape[1]
    h = common.embed_tokens(params["embed"], tokens)
    h = h + params["pos_embed"][:l].to(h.dtype)[None]
    acfg = _acfg(cfg, causal=True)
    selfs, cross_k, cross_v = [], [], []
    for lp in params["dec_layers"]:
        x = common.apply_norm(h, lp["ln_self"], cfg.norm)
        y, kv = attn.gqa_prefill(lp["self_attn"], x, acfg, layout)
        h = h + y
        x = common.apply_norm(h, lp["ln_cross"], cfg.norm)
        mkv = _memory_kv(lp["cross_attn"], memory, cfg)
        h = h + _cross_attention(lp["cross_attn"], x, mkv, cfg)
        h = _mlp_residual(lp, h, cfg)
        selfs.append(kv)
        cross_k.append(mkv[0])
        cross_v.append(mkv[1])
    caches = {"self": {k: torch.stack([c[k] for c in selfs])
                       for k in selfs[0]},
              "cross_k": torch.stack(cross_k),
              "cross_v": torch.stack(cross_v)}
    return _logits(params, h, cfg), caches


def encdec_decode(params: dict, tokens: torch.Tensor, caches: dict,
                  cfg: ModelConfig) -> torch.Tensor:
    """One decoder token for every slot (tokens [B, 1]): bf16 logits
    [B, V]; the self-attention caches update in place."""
    b = tokens.shape[0]
    pos = caches["self"]["len"][0].to(torch.int64)          # [B]
    h = common.embed_tokens(params["embed"], tokens)
    h = h + params["pos_embed"][pos].reshape(b, 1, -1).to(h.dtype)
    acfg = _acfg(cfg, causal=True)
    for i, lp in enumerate(params["dec_layers"]):
        x = common.apply_norm(h, lp["ln_self"], cfg.norm)
        h = h + attn.gqa_decode(lp["self_attn"], x, acfg,
                                {k: v[i] for k, v in caches["self"].items()})
        x = common.apply_norm(h, lp["ln_cross"], cfg.norm)
        q = split_heads(common.dense(x, lp["cross_attn"]["wq"]),
                        acfg.num_heads, acfg.head_dim)
        ck, cv = caches["cross_k"][i], caches["cross_v"][i]
        ctx = attn.attend_cache(q, ck, cv,
                                attn.lengths_like(ck, ck.shape[1]))
        h = h + common.dense(merge_heads(ctx), lp["cross_attn"]["wo"])
        h = _mlp_residual(lp, h, cfg)
    return _logits(params, h, cfg)


def encdec_cache_specs(cfg: ModelConfig, batch: int, layout: PagedLayout,
                       num_blocks: int | None = None) -> dict:
    """{"self": {leaf: ((L, ...), dtype)}, "cross_k" / "cross_v":
    ((L, B, enc_seq, Hkv, D), bf16)}."""
    acfg = _acfg(cfg, causal=True)
    self_spec = attn.gqa_cache_spec(batch, layout, acfg,
                                    num_blocks=num_blocks)
    l = cfg.num_layers
    cross = ((l, batch, cfg.encdec.enc_seq, acfg.num_kv_heads,
              acfg.head_dim), torch.bfloat16)
    return {"self": {k: ((l,) + shape, dtype)
                     for k, (shape, dtype) in self_spec.items()},
            "cross_k": cross, "cross_v": cross}
