"""Multi-head Latent Attention (DeepSeek-V2) over block-paged latent pools
(the serving half of ``repro.models.mla``).

The cache holds only the compressed latents, ``c_kv`` [nb, bs, kv_lora]
and the shared rope key ``k_rope`` [nb, bs, rope_dim] (int8 / fp8 pools
add one f32 scale per cached token each, [nb, bs]). Attention runs in
latent space: ``wk_b`` is absorbed into the query and ``wv_b`` applied to
the context latents.

* Chunked prefill (``mla_prefill_chunk``) runs the reference's plain
  masked-softmax ``_latent_attend`` over the gathered (dequantized)
  latents, on the CPU and on the card alike.
* Decode (``mla_decode``) and the speculative verify window
  (``mla_verify_chunk``, width C) run the latent paged-attention
  superkernel through ``kernels.ops.paged_attention(..., q_rope=...)``:
  its plain twin for CPU tensors, the CUDA kernel for CUDA tensors (the
  decision the GQA decode follows).

Caches are updated IN PLACE, as in ``models.attention``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import common, paged
from repro_torch.models.common import ParamSpec
from repro_torch.models.paged import PagedLayout
from repro_torch.quant import core as qcore


class MLAConfig(NamedTuple):
    num_heads: int = 128
    q_lora: int = 1536
    kv_lora: int = 512
    nope_dim: int = 128
    rope_dim: int = 64
    v_dim: int = 128
    rope_theta: float = 1e4
    # low-bit latent pools: one scale per cached token for c_kv and
    # k_rope each (the latent vector is the quantization tile)
    kv_dtype: str = "bf16"

    @property
    def softmax_scale(self) -> float:
        """(nope_dim + rope_dim)^-0.5: NOT derivable from the latent width."""
        return (self.nope_dim + self.rope_dim) ** -0.5


def mla_schema(d_model: int, cfg: MLAConfig) -> dict:
    h = cfg.num_heads
    qk = cfg.nope_dim + cfg.rope_dim
    return {
        "wq_a": ParamSpec((d_model, cfg.q_lora), init="fan_in"),
        "q_norm": ParamSpec((cfg.q_lora,), init="ones"),
        "wq_b": ParamSpec((cfg.q_lora, h * qk), init="fan_in"),
        "wkv_a": ParamSpec((d_model, cfg.kv_lora + cfg.rope_dim),
                           init="fan_in"),
        "kv_norm": ParamSpec((cfg.kv_lora,), init="ones"),
        "wk_b": ParamSpec((cfg.kv_lora, h * cfg.nope_dim), init="fan_in"),
        "wv_b": ParamSpec((cfg.kv_lora, h * cfg.v_dim), init="fan_in"),
        "wo": ParamSpec((h * cfg.v_dim, d_model), init="fan_in"),
    }


def _latents(p: dict, x: torch.Tensor, cfg: MLAConfig,
             positions: torch.Tensor):
    """(q_nope [B,L,H,n], q_rope [B,L,H,r], c_kv [B,L,c], k_rope [B,L,r])."""
    b, l, _ = x.shape
    h = cfg.num_heads
    q = common.dense(x, p["wq_a"])
    q = common.rms_norm(q, p["q_norm"])
    q = common.dense(q, p["wq_b"]).reshape(b, l, h,
                                           cfg.nope_dim + cfg.rope_dim)
    q_nope, q_rope = q[..., :cfg.nope_dim], q[..., cfg.nope_dim:]
    kv = common.dense(x, p["wkv_a"])
    c_kv, k_rope = kv[..., :cfg.kv_lora], kv[..., cfg.kv_lora:]
    c_kv = common.rms_norm(c_kv, p["kv_norm"])
    # rope: per head on q, one shared head on k
    q_rope = common.apply_rope(q_rope.transpose(1, 2), positions[:, None, :],
                               theta=cfg.rope_theta).transpose(1, 2)
    k_rope = common.apply_rope(k_rope[:, None], positions[:, None, :],
                               theta=cfg.rope_theta)[:, 0]
    return q_nope, q_rope, c_kv, k_rope


def _scatter_latents(cache: dict, c_kv: torch.Tensor, k_rope: torch.Tensor,
                     fmt: qcore.QuantFormat | None, scatter_fn) -> None:
    """In place: append latents (plus per-token scales when quantized)
    through ``scatter_fn(pool, vals)``."""
    if fmt is None:
        scatter_fn(cache["c_kv"], c_kv)
        scatter_fn(cache["k_rope"], k_rope)
        return
    q_ckv, s_ckv = qcore.quantize_lastdim(c_kv, fmt)
    q_kr, s_kr = qcore.quantize_lastdim(k_rope, fmt)
    scatter_fn(cache["c_kv"], q_ckv)
    scatter_fn(cache["k_rope"], q_kr)
    scatter_fn(cache["c_kv_scale"], s_ckv)
    scatter_fn(cache["k_rope_scale"], s_kr)


def _gather_latents(pools: dict, table: torch.Tensor,
                    fmt: qcore.QuantFormat | None, dtype):
    """Virtual latent rows, dequantized to ``dtype`` when quantized."""
    c_kv = paged.gather_blocks(pools["c_kv"], table)
    k_rope = paged.gather_blocks(pools["k_rope"], table)
    if fmt is None:
        return c_kv, k_rope
    return (qcore.dequantize_lastdim(
                c_kv, paged.gather_blocks(pools["c_kv_scale"], table), dtype),
            qcore.dequantize_lastdim(
                k_rope, paged.gather_blocks(pools["k_rope_scale"], table),
                dtype))


def _absorbed_q(p: dict, cfg: MLAConfig, q_nope: torch.Tensor
                ) -> torch.Tensor:
    """Absorb ``wk_b`` into the query: [B,Q,H,nope] -> latent-space query
    [B,Q,H,kv_lora] f32 (f32 master weights, not rounded)."""
    wk_b = p["wk_b"].reshape(cfg.kv_lora, cfg.num_heads, cfg.nope_dim)
    return torch.einsum("bqhn,chn->bqhc", q_nope.to(torch.float32),
                        wk_b.to(torch.float32))


def _apply_wv(p: dict, cfg: MLAConfig, ctx_lat: torch.Tensor
              ) -> torch.Tensor:
    """Context latents [B,Q,H,kv_lora] f32 through the absorbed value
    up-projection -> per-head context values [B,Q,H,v_dim] f32."""
    wv_b = p["wv_b"].reshape(cfg.kv_lora, cfg.num_heads, cfg.v_dim)
    return torch.einsum("bqhc,chv->bqhv", ctx_lat, wv_b.to(torch.float32))


def _latent_attend(p: dict, cfg: MLAConfig, q_nope, q_rope, c_kv, k_rope,
                   valid_len: torch.Tensor,
                   q_pos: torch.Tensor | None = None) -> torch.Tensor:
    """Absorbed latent attention, plain masked softmax: q [B,Q,H,*] vs
    latents [B,S,*]; ``q_pos`` [B,Q] adds the causal chunk mask. Returns
    per-head context values [B,Q,H,v_dim]."""
    q_lat = _absorbed_q(p, cfg, q_nope)
    s = (torch.einsum("bqhc,bsc->bhqs", q_lat, c_kv.to(torch.float32))
         + torch.einsum("bqhr,bsr->bhqs", q_rope.to(torch.float32),
                        k_rope.to(torch.float32))) * cfg.softmax_scale
    k_pos = torch.arange(c_kv.shape[1], device=c_kv.device)
    mask = (k_pos[None, :] < valid_len[:, None])[:, None, :]      # [B,1,S]
    if q_pos is not None:
        mask = mask & (q_pos[:, :, None] >= k_pos[None, None, :])
    s = torch.where(mask[:, None], s, -1e30)
    probs = torch.softmax(s, dim=-1)
    ctx_lat = torch.einsum("bhqs,bsc->bqhc", probs, c_kv.to(torch.float32))
    return _apply_wv(p, cfg, ctx_lat)


def _kernel_latent_attend(p: dict, cfg: MLAConfig, q_nope, q_rope,
                          pools: dict, table: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """Absorbed-latent attention through the latent paged-attention
    superkernel: one walk of the latent blocks, c_kv used for both the
    score and the value, per-token scales folded post-dot. Returns
    [B, Q, H, v_dim] f32."""
    ctx_lat = ops.paged_attention(
        _absorbed_q(p, cfg, q_nope), pools["c_kv"], None, table, lens,
        q_rope=q_rope.contiguous(), rope_pool=pools["k_rope"],
        kscale=pools.get("c_kv_scale"), rope_scale=pools.get("k_rope_scale"),
        scale=cfg.softmax_scale)
    return _apply_wv(p, cfg, ctx_lat)


def mla_decode(p: dict, x: torch.Tensor, cfg: MLAConfig, cache: dict
               ) -> torch.Tensor:
    """One-token latent decode; x [B, 1, d]; ``cache`` is one layer's view
    (latent pools, block_table [B, mb], len [B]), updated in place: the
    new token's latents are scattered at ``len``, which advances by one."""
    b = x.shape[0]
    idx = cache["len"].clone()
    table = cache["block_table"]
    q_nope, q_rope, c_kv_new, k_rope_new = _latents(p, x, cfg, idx[:, None])
    fmt = qcore.get_format(cfg.kv_dtype)
    _scatter_latents(cache, c_kv_new[:, 0], k_rope_new[:, 0], fmt,
                     lambda pool, vals: paged.scatter_token(pool, table, idx,
                                                            vals))
    ctx = _kernel_latent_attend(p, cfg, q_nope, q_rope, cache, table, idx + 1)
    cache["len"].copy_(idx + 1)
    return common.dense(ctx.reshape(b, 1, -1).to(x.dtype), p["wo"])


def mla_prefill_chunk(p: dict, x: torch.Tensor, cfg: MLAConfig, cache: dict,
                      slot: int, pos0: int) -> torch.Tensor:
    """Prefill one chunk (x [1, C, d]) of ONE sequence's latents into the
    shared paged cache, with a causal chunk mask; ``len[slot]`` becomes
    pos0 + C."""
    c = x.shape[1]
    positions = (pos0 + torch.arange(c, dtype=torch.int32,
                                     device=x.device))[None, :]
    q_nope, q_rope, c_kv_new, k_rope_new = _latents(p, x, cfg, positions)
    table_row = cache["block_table"][slot]
    fmt = qcore.get_format(cfg.kv_dtype)
    _scatter_latents(cache, c_kv_new[0], k_rope_new[0], fmt,
                     lambda pool, vals: paged.scatter_chunk(pool, table_row,
                                                            pos0, vals))
    c_kv, k_rope = _gather_latents(cache, table_row[None], fmt, x.dtype)
    valid = torch.full((1,), pos0 + c, dtype=torch.int32, device=x.device)
    ctx = _latent_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, valid,
                         q_pos=positions)
    cache["len"][slot] = pos0 + c
    return common.dense(ctx.reshape(1, c, -1).to(x.dtype), p["wo"])


def mla_verify_chunk(p: dict, x: torch.Tensor, cfg: MLAConfig, cache: dict,
                     slots: torch.Tensor, pos0s: torch.Tensor
                     ) -> torch.Tensor:
    """Speculative verify for MLA: append + attend a C-token latent window
    for each of S slots (x [S, C, d]) in one pass, as
    ``attention.gqa_verify_chunk`` does for GQA: the latents (and their
    per-token scales) through ``scatter_chunk_multi``, padding rows to
    the null block, then the latent superkernel at width C with
    ``lens = pos0s + C``. ``len[slots]`` becomes pos0s + C."""
    s_n, c, _ = x.shape
    slots = slots.to(torch.int64)
    pos0s = pos0s.to(torch.int32)
    positions = pos0s[:, None] + torch.arange(c, dtype=torch.int32,
                                              device=x.device)[None, :]
    q_nope, q_rope, c_kv_new, k_rope_new = _latents(p, x, cfg, positions)
    tables = cache["block_table"][slots]                       # [S, mb]
    live = paged.first_occurrence(slots)
    fmt = qcore.get_format(cfg.kv_dtype)
    _scatter_latents(cache, c_kv_new, k_rope_new, fmt,
                     lambda pool, vals: paged.scatter_chunk_multi(
                         pool, tables, pos0s, vals, live))
    ctx = _kernel_latent_attend(p, cfg, q_nope, q_rope, cache, tables,
                                pos0s + c)
    cache["len"][slots] = pos0s + c
    return common.dense(ctx.reshape(s_n, c, -1).to(x.dtype), p["wo"])


def mla_cache_spec(batch: int, layout: PagedLayout, cfg: MLAConfig,
                   dtype=torch.bfloat16, num_blocks: int | None = None
                   ) -> dict:
    """{leaf name: (shape, dtype)} of one layer's latent cache."""
    nb = (paged.default_num_blocks(layout, batch) if num_blocks is None
          else num_blocks)
    fmt = qcore.get_format(cfg.kv_dtype)
    store = dtype if fmt is None else fmt.storage
    spec = {"c_kv": ((nb, layout.block_size, cfg.kv_lora), store),
            "k_rope": ((nb, layout.block_size, cfg.rope_dim), store),
            "block_table": ((batch, layout.max_blocks), torch.int32),
            "len": ((batch,), torch.int32)}
    if fmt is not None:
        sshape = (nb, layout.block_size)        # one scale per cached token
        spec["c_kv_scale"] = (sshape, torch.float32)
        spec["k_rope_scale"] = (sshape, torch.float32)
    return spec
