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

import contextlib
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import kahan
from repro_torch.distributed.sharding import merge_heads
from repro_torch.ecm import step_cost
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
    from repro_torch.distributed.sharding import split_heads
    q = split_heads(common.dense(x, p["wq"], p.get("bq")), h, dh)
    k = split_heads(common.dense(x, p["wk"], p.get("bk")), kv, dh)
    v = split_heads(common.dense(x, p["wv"], p.get("bv")), kv, dh)
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

    Packed: under the conditions of the reference's ``causal_packing``
    (causal, Lq == Lk in as many blocks, no ``kv_len``, no ``kahan_acc``,
    ``q_offset`` the int 0) only the nq(nq+1)/2 key blocks on or below
    the diagonal are walked. A block past the diagonal is all masked and
    adds exact zeros (p = 0, corr = exp(0) = 1), so the packed walk is
    bitwise the full one. The block walks are ``step_cost.trips``: a cost
    trace may run one block for all of them. Under autograd, inside a
    training loss (``beside_loss``), a walk of more than one query block
    checkpoints each one (the reference's per-chunk ``jax.checkpoint``)
    where the scores its backward would keep outweigh what the loss
    holds: recompute is deterministic, so the gradients keep their bits,
    and a backward holds one block row's scores at a time.

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
        k, v = _pad_seq(k, pad_k), _pad_seq(v, pad_k)
        if kv_len is None:
            kv_len = lk_orig
    if pad_q:
        q = _pad_seq(q, pad_q)
    lq, lk = lq_orig + pad_q, lk_orig + pad_k
    nq, nk = lq // qc, lk // kc
    packed = (causal and lq == lk and nq == nk
              and kv_len is None and not kahan_acc
              and isinstance(q_offset, int) and q_offset == 0)
    from repro_torch.distributed.sharding import per_shard, shard_act
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
    # per (sequence, head) pair: a DTensor split over those alone runs on
    # each rank's local blocks
    out = per_shard(
        lambda qg, kt, vt: _flash_walk(
            qg, kt, vt, q_offset=q_offset, kv_len=kv_len, causal=causal,
            packed=packed, kahan_acc=kahan_acc, kernel=kernel, scale=scale,
            kc=kc, nk=nk),
        (qg, kt, vt), ({0: 0, 1: 1},) * 3, ({0: 0, 1: 1},),
        whole=q_offset.dim() == 0 and (kv_len is None or kv_len.dim() == 0))
    out = out.reshape(b, hq, lq, dv).permute(0, 2, 1, 3).to(v.dtype)
    return out[:, :lq_orig] if pad_q else out


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [B, L, H, D] with n zero positions after its L. A DTensor whose
    sequence is whole pads each rank's local tensor (some DTensor
    versions lay out a pad's output with one placement on a mesh of
    two dims, which the next view refuses)."""
    from repro_torch.distributed.sharding import per_shard
    dims = {0: 0, 2: 2, 3: 3}
    return per_shard(
        lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n)), (x,),
        (dims,), (dims,))


def _flash_walk(qg, kt, vt, *, q_offset, kv_len, causal, packed, kahan_acc,
                kernel, scale, kc, nk) -> torch.Tensor:
    """The block walk of ``flash_attention``: qg [B, Hkv, G, nq, qc, D],
    kt / vt [B, Hkv, Lk, D(v)] -> [B, Hkv, G, Lq, Dv] f32."""
    b, hkv, groups, nq, qc, d = qg.shape
    dv = vt.shape[-1]
    dev = qg.device

    def q_block(qi, qg, kt, vt):
        q_blk = qg[:, :, :, qi].to(torch.float32)        # [B,Hkv,G,qc,D]
        # [qc] for a scalar offset, [B, qc] for a per-slot one
        q_pos = (q_offset[..., None] + qi * qc
                 + torch.arange(qc, device=dev))
        m = torch.full((b, hkv, groups, qc), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, groups, qc), device=dev)
        acc = torch.zeros((b, hkv, groups, qc, dv), device=dev)
        acc_c = torch.zeros_like(acc)
        for ki in step_cost.trips(qi + 1 if packed else nk,
                                  weight=(nq + 1) / 2 if packed else None):
            k_blk = kt[:, :, ki * kc:(ki + 1) * kc]
            v_blk = vt[:, :, ki * kc:(ki + 1) * kc]
            if kernel:
                s = invariant_gemm.product(
                    q_blk.reshape(b, hkv, groups * qc, d),
                    k_blk.transpose(2, 3),
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
                    p.reshape(b, hkv, groups * qc, kc), v_blk,
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
        return acc / torch.clamp_min(l, 1e-30)[..., None]

    walk = q_block
    pairs = nq * (nq + 1) // 2 if packed else nq * nk
    kept = (_local_numel(qg) // (nq * d) * kc * pairs * SCORE_BYTES)
    if nq > 1 and torch.is_grad_enabled() and any(
            t.requires_grad for t in (qg, kt, vt)) and \
            _LOSS_BYTES[-1] is not None and kept > _LOSS_BYTES[-1]:
        # the reference's per-query-block checkpoint: backward recomputes
        # one block row at a time, so it holds one row's scores, not the
        # walk's (one block alone would only be recomputed twice). The
        # operands go in as arguments: a recomputed layer's checkpoint
        # frees those, where a closure would keep them to the backward
        def walk(*a):
            return checkpoint(q_block, *a, use_reentrant=False)
    outs = [walk(qi, qg, kt, vt) for qi in step_cost.trips(nq)]
    outs = step_cost.fill(outs, nq)
    return torch.stack(outs, dim=3).reshape(b, hkv, groups, nq * qc, dv)


# bytes a layer's backward keeps for each score of a walked block pair
# when its walk is not checkpointed per query block: the masked scores
# (amax), their exp and the f32 probabilities the PV product took
SCORE_BYTES = 12
# bytes the loss holds for each logit at its own peak in backward: the
# f32 logits, the label gather's scatter, the exp and their product on a
# vocabulary split over ranks (``sharding.vocab_parallel_ce``), and the
# plain logsumexp's x - max beside them on a whole one
LOSS_BYTES_PER_LOGIT = {True: 16, False: 20}
# what the step's loss holds at its peak, set by ``beside_loss``; None
# outside a training loss
_LOSS_BYTES: list = [None]


def _local_numel(t: torch.Tensor) -> int:
    from torch.distributed.tensor import DTensor
    return t.to_local().numel() if isinstance(t, DTensor) else t.numel()


def loss_bytes(labels: torch.Tensor, head: torch.Tensor,
               vocab_dim: int) -> int:
    """What a step's cross entropy holds at its peak on this rank: its
    local label count times the head's local vocabulary, at
    ``LOSS_BYTES_PER_LOGIT``."""
    from torch.distributed.tensor import DTensor
    local = head.to_local() if isinstance(head, DTensor) else head
    vocab = local.shape[vocab_dim]
    return (_local_numel(labels) * vocab
            * LOSS_BYTES_PER_LOGIT[vocab < head.shape[vocab_dim]])


# bytes a layer's backward holds beside the scores its walk keeps
# (``layer_bytes``), read off the backward's peak of a qwen1.5-110b
# train_4k layer on 16 x 16 (``tools/dryrun_peak.py``; with them the rule
# reads the always-checkpointed walk's peak there and on olmoe's MoE
# layers, which PERF.md section 6 records): for each element
# of its [T, d] stream on this rank, the norms' f32 inputs and scaled
# rows, the products' f32 results and the bf16 rows the residual adds;
# for each element of its FFN's hidden rows on this rank, the bf16
# gate/up pair, the f32 SiLU input, its bf16 output and their product
LAYER_BYTES_PER_EMBED = 36
LAYER_BYTES_PER_HIDDEN = 12


def layer_bytes(h: torch.Tensor, hidden: tuple) -> int:
    """What a layer's backward holds beside its kept scores, on this
    rank: h's local [T, d] elements and, for each (rows, columns) of
    ``hidden``, the FFN's hidden elements."""
    return (_local_numel(h) * LAYER_BYTES_PER_EMBED
            + sum(r * c for r, c in hidden) * LAYER_BYTES_PER_HIDDEN)


def grads_after_first_layer(leaves: list, labels: torch.Tensor,
                            d_model: int) -> int:
    """What a step's end holds that its first layer's backward does not,
    on this rank: the gradients (each leaf's local bytes) of ``leaves``,
    the first layer's parameters and those the forward meets before it,
    less the layer input that remat keeps for its recompute (a bf16
    [tokens, d] block, ``labels``' local count of tokens). Where that
    outweighs a walk's scores with its layer's transient, the step peaks
    at its end (the optimizer's update, every gradient live), not at a
    layer's backward, and checkpointing the walk saves nothing."""
    return (sum(_local_numel(t) * t.element_size() for t in leaves)
            - _local_numel(labels) * d_model * 2)


@contextlib.contextmanager
def beside_layer(nbytes: int):
    """Within, a walk's scores are weighed against what ``beside_loss``
    set less ``nbytes``, the layer's own backward transient
    (``layer_bytes``): the layer's backward peaks at its kept scores
    plus that, so the walk is checkpointed where the two together
    outweigh it. Outside a training loss it changes nothing."""
    cur = _LOSS_BYTES[-1]
    _LOSS_BYTES.append(None if cur is None else cur - nbytes)
    try:
        yield
    finally:
        _LOSS_BYTES.pop()


@contextlib.contextmanager
def beside_loss(nbytes: int | None):
    """Within, a training walk of more than one query block checkpoints
    each block where the scores a layer's backward would keep for its
    whole walk (``SCORE_BYTES`` each), with the layer's own backward
    transient (``beside_layer``), outweigh ``nbytes``: what the step
    holds at its other peaks, the loss's (``loss_bytes``) or, where
    more, what its end holds beyond the first layer's backward
    (``grads_after_first_layer``). There the layer's recompute would
    set the step's peak. Elsewhere the walk is kept whole, and a
    backward pays no third forward."""
    _LOSS_BYTES.append(nbytes)
    try:
        yield
    finally:
        _LOSS_BYTES.pop()


def keeping_loss_bytes(fn):
    """``fn``, run under the ``beside_loss`` in force now: a layer's
    checkpoint recomputes it in backward, after the loss's context has
    closed, and its walk must take the same form again."""
    nbytes = _LOSS_BYTES[-1]

    def run(*args, **kwargs):
        with beside_loss(nbytes):
            return fn(*args, **kwargs)
    return run


def seq_positions(length: int, device) -> torch.Tensor:
    """Positions 0..length-1 of every sequence, [1, length]: broadcast
    over the batch, never expanded to it (a DTensor's global batch would
    make the RoPE tables whole on every rank)."""
    return torch.arange(length, device=device)[None, :]


def lengths_like(x: torch.Tensor, length: int) -> torch.Tensor:
    """[B] int32 ``length`` per sequence of x [B, ...], laid out as x's
    batch (a DTensor stays one)."""
    return torch.full_like(x[(slice(None),) + (0,) * (x.ndim - 1)], length,
                           dtype=torch.int32)


def gqa_forward(p: dict, x: torch.Tensor, cfg: AttnConfig, *,
                positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence (training) GQA block, x [B, L, d] -> [B, L, d]:
    ``flash_attention`` over the sequence's own K/V, differentiable under
    autograd (every op is out of place)."""
    b, l, _ = x.shape
    if positions is None:
        positions = seq_positions(l, x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = flash_attention(q, k, v, causal=cfg.causal, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk, kahan_acc=cfg.kahan_acc)
    return common.dense(merge_heads(out), p["wo"])


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
    positions = seq_positions(l, x.device)
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
             "len": lengths_like(x, l),
             **scale_pools}
    return common.dense(merge_heads(out), p["wo"]), cache


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
    return common.dense(merge_heads(out), p["wo"])


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
    return common.dense(merge_heads(out), p["wo"])


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
