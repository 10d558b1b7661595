"""GQA attention over block-paged KV (the GQA half of
``repro.models.attention``).

* The training forward (``gqa_forward``), the one-shot prefill
  (``gqa_prefill``) and chunked prefill (``gqa_prefill_chunk``) run the
  reference's blockwise online-softmax ``flash_attention`` in PyTorch
  ops (in the reference it is plain JAX, not a Pallas kernel); on the
  served path on the card its score and PV products run the M-invariant
  bf16 kernel, so a row's attention keeps its bits at any chunk length.
* Decode (``gqa_decode``) runs the paged-attention superkernel through
  ``kernels.ops.paged_attention``: its plain twin for CPU tensors, the
  CUDA kernel for CUDA tensors. So on the card decode-written KV is not
  bitwise prefill-written KV (kernel vs flash formulation); this slice
  relies on no such parity.
* The speculative verify window (``gqa_verify_chunk``) runs the same
  superkernel at width C, the reference's TPU branch, on both devices:
  row w of the window is bitwise the width-1 decode call at its
  position on the same pools.

Caches are updated IN PLACE: the K/V (and scale) pools through
``index_put_``, ``len`` by assignment into the per-layer view.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import kahan
from repro_torch.kernels import invariant_gemm, ops
from repro_torch.kernels.paged_attention import NEG_INF
from repro_torch.models import common, paged
from repro_torch.models.common import ParamSpec
from repro_torch.models.paged import PagedLayout
from repro_torch.quant import core as qcore


class AttnConfig(NamedTuple):
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rotary_fraction: float = 1.0
    q_chunk: int = 512
    kv_chunk: int = 512
    kahan_acc: bool = False
    causal: bool = True
    kv_dtype: str = "bf16"


def gqa_schema(d_model: int, cfg: AttnConfig) -> dict:
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {"wq": ParamSpec((d_model, h * dh), ("embed", "q_heads"),
                         init="fan_in"),
         "wk": ParamSpec((d_model, kv * dh), ("embed", "kv_heads"),
                         init="fan_in"),
         "wv": ParamSpec((d_model, kv * dh), ("embed", "kv_heads"),
                         init="fan_in"),
         "wo": ParamSpec((h * dh, d_model), ("q_heads", "embed"),
                         init="fan_in")}
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h * dh,), ("q_heads",), init="zeros")
        s["bk"] = ParamSpec((kv * dh,), ("kv_heads",), init="zeros")
        s["bv"] = ParamSpec((kv * dh,), ("kv_heads",), init="zeros")
    return s


def _shard_blhd(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D] activations: batch over (pod, data), heads over model
    (``distributed.sharding.shard_act``: x itself outside a mesh)."""
    from repro_torch.distributed.sharding import shard_act
    return shard_act(x, "act_batch", "act_seq", "act_heads", None)


def _project_qkv(p: dict, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor):
    b, l, _ = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = common.dense(x, p["wq"], p.get("bq")).reshape(b, l, h, dh)
    k = common.dense(x, p["wk"], p.get("bk")).reshape(b, l, kv, dh)
    v = common.dense(x, p["wv"], p.get("bv")).reshape(b, l, kv, dh)
    rd = int(dh * cfg.rotary_fraction)
    if rd:
        pos = positions[:, None, :]
        q = common.apply_rope(q.transpose(1, 2), pos, theta=cfg.rope_theta,
                              rotary_dim=rd).transpose(1, 2)
        k = common.apply_rope(k.transpose(1, 2), pos, theta=cfg.rope_theta,
                              rotary_dim=rd).transpose(1, 2)
    return _shard_blhd(q), _shard_blhd(k), _shard_blhd(v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 512, kahan_acc: bool = False,
                    kv_len=None, q_offset=0) -> torch.Tensor:
    """Blockwise online-softmax attention. q [B, Lq, Hq, D]; k/v
    [B, Lk, Hkv, D(v)] -> [B, Lq, Hq, Dv] in v's dtype.

    ``q_offset`` places the queries at absolute positions
    offset..offset+Lq-1; ``q_offset`` and ``kv_len`` take an int, a 0-d
    tensor or a per-batch [B] tensor. Scores and PV products are f32
    products of the bf16 operands, as in the reference's einsums with
    f32 accumulation: on the card with bf16 q / k / v and autograd
    recording nothing (serving), the M-invariant bf16 kernel through
    ``invariant_gemm.product``, its K split planned for the heads alone
    so a sequence's bits do not depend on how many share the call, over
    key blocks of ``kv_chunk`` whatever Lk is; elsewhere f32 einsums of
    the widened operands over blocks of min(``kv_chunk``, Lk), the
    reference's."""
    b, lq_orig, hq, d = q.shape
    _, lk_orig, hkv, dv = v.shape
    dev = q.device
    kernel = (q.dtype == k.dtype == v.dtype == torch.bfloat16
              and invariant_gemm.use_kernel(q, k, v))
    if hkv < hq:
        groups = hq // hkv
        k = _shard_blhd(torch.repeat_interleave(k, groups, dim=2))
        v = _shard_blhd(torch.repeat_interleave(v, groups, dim=2))
        hkv = hq
    groups = hq // hkv
    scale = d ** -0.5
    qc = min(q_chunk, lq_orig)
    # served on the kernel, every key block is kv_chunk wide (past the
    # keys padded and masked), as the engine's chunks over a slot's pool
    # are: a one-shot prefill then sums each row as the engine does
    kc = kv_chunk if kernel else min(kv_chunk, lk_orig)
    pad_q = (-lq_orig) % qc
    pad_k = (-lk_orig) % kc
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        if kv_len is None:
            kv_len = lk_orig
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    lq, lk = lq_orig + pad_q, lk_orig + pad_k
    nq, nk = lq // qc, lk // kc
    from repro_torch.distributed.sharding import shard_act
    # [B, Hkv, G, Lq, D] / [B, Hkv, Lk, D]
    qg = shard_act(q.reshape(b, lq, hkv, groups, d).permute(0, 2, 3, 1, 4),
                   "act_batch", "act_heads", None, "act_seq", None)
    kt = shard_act(k.permute(0, 2, 1, 3),
                   "act_batch", "act_heads", "act_seq", None)
    vt = shard_act(v.permute(0, 2, 1, 3),
                   "act_batch", "act_heads", "act_seq", None)
    qg = qg.reshape(b, hkv, groups, nq, qc, d)
    kt = kt.to(torch.float32)
    q_offset = torch.as_tensor(q_offset, device=dev)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev)
    outs = []
    for qi in range(nq):
        q_blk = qg[:, :, :, qi].to(torch.float32)        # [B,Hkv,G,qc,D]
        # [qc] for a scalar offset, [B, qc] for a per-slot one
        q_pos = (q_offset[..., None] + qi * qc
                 + torch.arange(qc, device=dev))
        m = torch.full((b, hkv, groups, qc), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, groups, qc), device=dev)
        acc = torch.zeros((b, hkv, groups, qc, dv), device=dev)
        acc_c = torch.zeros_like(acc)
        for ki in range(nk):
            k_blk = kt[:, :, ki * kc:(ki + 1) * kc]
            v_blk = vt[:, :, ki * kc:(ki + 1) * kc]
            if kernel:
                s = invariant_gemm.product(
                    q_blk.reshape(b * hkv, groups * qc, d),
                    k_blk.transpose(2, 3).reshape(b * hkv, d, kc),
                    plan_batch=hkv).reshape(b, hkv, groups, qc, kc)
                s = s * scale
            else:
                s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk) * scale
            k_pos = ki * kc + torch.arange(kc, device=dev)
            mask = torch.ones(tuple(q_pos.shape[:-1]) + (qc, kc),
                              dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[..., None] >= k_pos
            if kv_len is not None:
                mask &= k_pos < kv_len[..., None, None]
            mb_ = mask if mask.dim() == 2 else mask[:, None, None]
            s = torch.where(mb_, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]) * mb_
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            if kernel:
                pv = invariant_gemm.product(
                    p.reshape(b * hkv, groups * qc, kc),
                    v_blk.reshape(b * hkv, kc, dv),
                    plan_batch=hkv).reshape(b, hkv, groups, qc, dv)
            else:
                pv = torch.einsum("bhgqk,bhkd->bhgqd",
                                  p.to(v_blk.dtype).to(torch.float32),
                                  v_blk.to(torch.float32))
            if kahan_acc:
                acc, acc_c = kahan.neumaier_step(acc * corr[..., None],
                                                 acc_c * corr[..., None], pv)
            else:
                acc = acc * corr[..., None] + pv
            m = m_new
        if kahan_acc:
            acc = acc + acc_c
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs, dim=3).reshape(b, hkv, groups, lq, dv)
    out = out.reshape(b, hq, lq, dv).permute(0, 2, 1, 3).to(v.dtype)
    return out[:, :lq_orig] if pad_q else out


def gqa_forward(p: dict, x: torch.Tensor, cfg: AttnConfig, *,
                positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence (training) GQA block, x [B, L, d] -> [B, L, d]:
    ``flash_attention`` over the sequence's own K/V, differentiable under
    autograd (every op is out of place)."""
    b, l, _ = x.shape
    if positions is None:
        positions = torch.arange(l, device=x.device)[None, :].expand(b, l)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = flash_attention(q, k, v, causal=cfg.causal, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk, kahan_acc=cfg.kahan_acc)
    return common.dense(out.reshape(b, l, -1), p["wo"])


def attend_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention against materialized bf16 K/V rows, plain:
    q [B, 1, Hq, D], k / v [B, S, Hkv, D], valid_len [B] -> [B, 1, Hq, D]
    in v's dtype. f32 scores of the widened operands, a masked softmax,
    then the probabilities rounded to v's dtype against v with f32 sums,
    as the reference's bf16 path. Whisper's cross-attention decode reads
    the encoder memory through it."""
    b, _, hq, d = q.shape
    _, s_max, hkv, dv = v.shape
    groups = hq // hkv
    qg = q.reshape(b, hkv, groups, d).to(torch.float32)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.to(torch.float32)) * d ** -0.5
    mask = (torch.arange(s_max, device=q.device)[None, :]
            < valid_len[:, None])                               # [B, S]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, 1, hq, dv).to(v.dtype)


def gqa_prefill(p: dict, x: torch.Tensor, cfg: AttnConfig,
                layout: PagedLayout) -> tuple[torch.Tensor, dict]:
    """One-shot prefill, x [B, L, d] -> (out [B, L, d], a fresh
    block-paged cache): ``flash_attention`` over the sequence's own K/V,
    whose rows are laid into an identity-table pool (a reshape: the
    later block gather reads them back bitwise). Under an int8 / fp8
    ``kv_dtype`` the rows are quantized per (token, head) first and the
    attention runs over the dequantized values, which is what every
    later reader of the cache sees."""
    b, l, _ = x.shape
    positions = torch.arange(l, device=x.device)[None, :].expand(b, l)
    q, k, v = _project_qkv(p, x, cfg, positions)
    fmt = qcore.get_format(cfg.kv_dtype)
    scale_pools = {}
    k_store, v_store = k, v
    if fmt is not None:
        k_store, sk = qcore.quantize_lastdim(k, fmt)
        v_store, sv = qcore.quantize_lastdim(v, fmt)
        k = qcore.dequantize_lastdim(k_store, sk, x.dtype)
        v = qcore.dequantize_lastdim(v_store, sv, x.dtype)
        scale_pools = {"kscale": paged.pool_from_rows(sk, layout),
                       "vscale": paged.pool_from_rows(sv, layout)}
    out = flash_attention(q, k, v, causal=cfg.causal, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk, kahan_acc=cfg.kahan_acc)
    cache = {"kpool": paged.pool_from_rows(k_store, layout),
             "vpool": paged.pool_from_rows(v_store, layout),
             "block_table": paged.identity_table(b, layout, x.device),
             "len": torch.full((b,), l, dtype=torch.int32, device=x.device),
             **scale_pools}
    return common.dense(out.reshape(b, l, -1), p["wo"]), cache


def _scatter_kv(cache: dict, k: torch.Tensor, v: torch.Tensor,
                fmt: qcore.QuantFormat | None, scatter_fn) -> None:
    """In place: append K/V payloads (and, when quantized, their
    per-(token, head) scales) through ``scatter_fn(pool, vals)``."""
    if fmt is None:
        scatter_fn(cache["kpool"], k)
        scatter_fn(cache["vpool"], v)
        return
    qk, sk = qcore.quantize_lastdim(k, fmt)
    qv, sv = qcore.quantize_lastdim(v, fmt)
    scatter_fn(cache["kpool"], qk)
    scatter_fn(cache["vpool"], qv)
    scatter_fn(cache["kscale"], sk)
    scatter_fn(cache["vscale"], sv)


def _gather_kv(pools: dict, table: torch.Tensor,
               fmt: qcore.QuantFormat | None, dtype):
    """Virtual K/V rows from the pools, dequantized to ``dtype`` when the
    pools are quantized."""
    k = paged.gather_blocks(pools["kpool"], table)
    v = paged.gather_blocks(pools["vpool"], table)
    if fmt is None:
        return k, v
    return (qcore.dequantize_lastdim(
                k, paged.gather_blocks(pools["kscale"], table), dtype),
            qcore.dequantize_lastdim(
                v, paged.gather_blocks(pools["vscale"], table), dtype))


def gqa_decode(p: dict, x: torch.Tensor, cfg: AttnConfig, cache: dict
               ) -> torch.Tensor:
    """One-token paged decode; x [B, 1, d]; ``cache`` is one layer's view
    (pools, block_table [B, mb], len [B]), updated in place: the new
    token's (quantized) K/V are scattered at ``len`` and ``len`` advances
    by one. Attention is the paged superkernel at width 1."""
    b = x.shape[0]
    idx = cache["len"].clone()
    table = cache["block_table"]
    q, k_new, v_new = _project_qkv(p, x, cfg, idx[:, None])
    fmt = qcore.get_format(cfg.kv_dtype)
    _scatter_kv(cache, k_new[:, 0], v_new[:, 0], fmt,
                lambda pool, vals: paged.scatter_token(pool, table, idx,
                                                       vals))
    out = ops.paged_attention(q, cache["kpool"], cache["vpool"], table,
                              idx + 1, kscale=cache.get("kscale"),
                              vscale=cache.get("vscale")).to(x.dtype)
    cache["len"].copy_(idx + 1)
    return common.dense(out.reshape(b, 1, -1), p["wo"])


def gqa_prefill_chunk(p: dict, x: torch.Tensor, cfg: AttnConfig,
                      cache: dict, slot: int, pos0: int) -> torch.Tensor:
    """Prefill one chunk of ONE sequence into the shared paged cache.

    x [1, C, d]; ``slot`` indexes the batched cache, ``pos0`` is the
    number of tokens already cached for it. The chunk's K/V are scattered
    in place into the slot's blocks, then the chunk's queries run flash
    attention over the gathered prefix + chunk with ``q_offset=pos0``;
    ``len[slot]`` becomes pos0 + C."""
    c = x.shape[1]
    positions = (pos0 + torch.arange(c, dtype=torch.int32,
                                     device=x.device))[None, :]
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    table_row = cache["block_table"][slot]
    fmt = qcore.get_format(cfg.kv_dtype)
    _scatter_kv(cache, k_new[0], v_new[0], fmt,
                lambda pool, vals: paged.scatter_chunk(pool, table_row, pos0,
                                                       vals))
    k, v = _gather_kv(cache, table_row[None], fmt, x.dtype)
    out = flash_attention(q, k, v, causal=cfg.causal, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk, kahan_acc=cfg.kahan_acc,
                          q_offset=pos0, kv_len=pos0 + c)
    cache["len"][slot] = pos0 + c
    return common.dense(out.reshape(1, c, -1), p["wo"])


def gqa_verify_chunk(p: dict, x: torch.Tensor, cfg: AttnConfig,
                     cache: dict, slots: torch.Tensor,
                     pos0s: torch.Tensor) -> torch.Tensor:
    """Speculative verify: append + attend a C-token window for each of S
    slots in one pass.

    x [S, C, d]; ``slots`` [S] index the batched cache, ``pos0s`` [S] are
    their cached lengths (the window lands at pos0..pos0+C-1). The
    window's (quantized) K/V go through ``_scatter_kv``, the decode
    append's quantize-on-write, with rows repeating an earlier row's slot
    (the frame's padding) sent to the null block; then the superkernel
    runs at width C with ``lens = pos0s + C``, so row w sees the keys
    below pos0 + w + 1 and is bitwise the width-1 decode call at that
    position on the same pools. ``len[slots]`` becomes pos0s + C; the
    caller rolls rejected suffixes back with ``paged.set_lens``."""
    s_n, c, _ = x.shape
    slots = slots.to(torch.int64)
    pos0s = pos0s.to(torch.int32)
    positions = pos0s[:, None] + torch.arange(c, dtype=torch.int32,
                                              device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    tables = cache["block_table"][slots]                       # [S, mb]
    live = paged.first_occurrence(slots)
    fmt = qcore.get_format(cfg.kv_dtype)
    _scatter_kv(cache, k_new, v_new, fmt,
                lambda pool, vals: paged.scatter_chunk_multi(
                    pool, tables, pos0s, vals, live))
    out = ops.paged_attention(q, cache["kpool"], cache["vpool"], tables,
                              pos0s + c, kscale=cache.get("kscale"),
                              vscale=cache.get("vscale")).to(x.dtype)
    cache["len"][slots] = pos0s + c
    return common.dense(out.reshape(s_n, c, -1), p["wo"])


def gqa_cache_spec(batch: int, layout: PagedLayout, cfg: AttnConfig,
                   dtype=torch.bfloat16, num_blocks: int | None = None
                   ) -> dict:
    """{leaf name: (shape, dtype)} of one layer's paged cache."""
    nb = (paged.default_num_blocks(layout, batch) if num_blocks is None
          else num_blocks)
    fmt = qcore.get_format(cfg.kv_dtype)
    pool = (nb, layout.block_size, cfg.num_kv_heads, cfg.head_dim)
    store = dtype if fmt is None else fmt.storage
    spec = {"kpool": (pool, store), "vpool": (pool, store),
            "block_table": ((batch, layout.max_blocks), torch.int32),
            "len": ((batch,), torch.int32)}
    if fmt is not None:
        sshape = (nb, layout.block_size, cfg.num_kv_heads)
        spec["kscale"] = (sshape, torch.float32)
        spec["vscale"] = (sshape, torch.float32)
    return spec
