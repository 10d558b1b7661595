"""Mixture-of-Experts with capacity-based sort routing (twin of
``repro.models.moe``).

Tokens are sorted by expert id (stable: earlier tokens win capacity
ties), gathered into fixed-capacity ``[E, C, d]`` buckets, run through
one batched expert FFN, and folded back with their gates. Two places
differ in HOW the reference's arithmetic is carried out, not in what it
computes:

* **Expert products.** The reference multiplies bf16 operands with f32
  accumulation and rounds to bf16. The port does what ``common.dense``
  does: on the card one bf16 tensor-core product with an f32 result over
  the expert weights, which the load path holds as bf16 (the batched
  M-invariant kernel when serving, a differentiable ``bmm`` in
  training); on the CPU the
  operands widened to f32, experts a chunk at a time, so a full-width
  layer (a [160, 5120, 3072] ``w_gate_up``) never makes more than a
  ~1 GiB f32 copy of its weights per call.
* **Scatter back.** The reference's ``.at[st].add`` adds each token's k
  contributions in bf16, in sorted (expert-id) order, starting from zero.
  ``index_add_`` on a CUDA bf16 tensor uses atomics, whose order (and so
  rounding) changes from run to run; the port instead un-permutes the
  contributions into a [T, k] layout ordered by expert id and adds them
  left to right, which is that order on every device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import invariant_gemm
from repro_torch.models import common
from repro_torch.models.common import ParamSpec
from repro_torch.models.mlp import mlp_forward, mlp_schema


class MoEConfig(NamedTuple):
    num_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    num_shared: int = 0          # always-active shared experts (DeepSeek-V2)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2


def moe_schema(d_model: int, cfg: MoEConfig) -> dict:
    e, ff = cfg.num_experts, cfg.d_ff
    s = {"router": ParamSpec((d_model, e), ("embed", None), init="fan_in"),
         "w_gate_up": ParamSpec((e, d_model, 2 * ff),
                               ("experts", "embed", "mlp"), init="fan_in"),
         "w_down": ParamSpec((e, ff, d_model),
                            ("experts", "mlp", "embed"), init="fan_in")}
    if cfg.num_shared:
        s["shared"] = mlp_schema(d_model, cfg.num_shared * ff)
    return s


def capacity(tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest per row, ties to the lower index
    (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[E, C, d] x [E, d, f] -> [E, C, f] f32: bf16-rounded operands, f32
    products and sums, through ``invariant_gemm.product``: on the card
    the batched M-invariant kernel when autograd records nothing
    (serving), ``_Bf16BatchedProduct`` under autograd (training); on the
    CPU the operands widened to f32, a chunk of experts at a time. A
    DTensor product's partial sums are reduced in f32, as ``dense``
    does."""
    y = invariant_gemm.product(x, w)
    if type(y) is not torch.Tensor:
        from repro_torch.distributed.sharding import reduce_partial
        y = reduce_partial(y)
    return y


def moe_forward(p: dict, x: torch.Tensor, cfg: MoEConfig
                ) -> tuple[torch.Tensor, dict]:
    """x [B, L, d] -> (y [B, L, d], aux losses dict)."""
    b, l, d = x.shape
    t = b * l
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity(t, cfg)
    dev = x.device
    xf = x.reshape(t, d)

    logits = common.dense(xf, p["router"]).to(torch.float32)     # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # the routing (top-k, sorts, counts, slot scatters), the bucket
    # gather and the fold back run on plain tensors: a DTensor's router
    # outputs, tokens and expert outputs are gathered to every rank whole
    # (a replicated dispatch; DTensor has no rule for these index ops on
    # sharded tensors), and only the expert products run laid out, over
    # the experts
    from repro_torch.distributed.sharding import (gathered, replicated_on,
                                                  shard_act)
    top_p, top_e = _top_k(gathered(probs), k)                     # [T, k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # ---- sort assignments by expert --------------------------------------
    flat_e = top_e.reshape(-1)                                    # [T*k]
    flat_gate = top_p.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sg = flat_e[order], order // k, flat_gate[order]
    # bincount's output length depends on the data; the expert ids are
    # below e, so the counts are these
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))                       # [E]
    offsets = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(t * k, device=dev) - offsets[se]
    keep = ranks < cap
    slot = torch.where(keep, se * cap + ranks,
                       torch.full_like(se, e * cap))              # drop -> sentinel

    # ---- gather tokens into [E, C, d] buckets -----------------------------
    slot_to_tok = torch.full((e * cap + 1,), t, dtype=torch.int64, device=dev)
    slot_to_tok[slot] = st
    slot_to_tok = slot_to_tok[:e * cap]
    valid = slot_to_tok < t
    xe = gathered(xf)[torch.clamp(slot_to_tok, 0, t - 1)] \
        * valid[:, None].to(xf.dtype)
    xe = shard_act(replicated_on(xe.reshape(e, cap, d), xf),
                   "act_experts", None, None)

    # ---- batched expert FFN ----------------------------------------------
    gate, up = torch.chunk(_expert_matmul(xe, p["w_gate_up"]).to(xe.dtype),
                           2, dim=-1)
    ye = _expert_matmul(common.swiglu(gate, up), p["w_down"]).to(xe.dtype)

    # ---- weighted fold back to tokens, in sorted order --------------------
    yflat = gathered(ye).reshape(e * cap, d)
    contrib = yflat[torch.clamp(slot, 0, e * cap - 1)]
    contrib = contrib * (sg * keep).to(contrib.dtype)[:, None]
    # sorted position of each (token, expert) pair, then each token's k
    # pairs in expert-id order: the order the sorted scatter visits them
    pos = torch.empty_like(order)
    pos[order] = torch.arange(t * k, device=dev)
    pos = torch.sort(pos.reshape(t, k), dim=1).values
    per_tok = contrib[pos]                                        # [T, k, d]
    y = torch.zeros((t, d), dtype=contrib.dtype, device=dev)
    for j in range(k):
        y = y + per_tok[:, j]
    y = replicated_on(y, xf)

    if cfg.num_shared:
        y = y + mlp_forward(p["shared"], xf)

    # ---- aux losses --------------------------------------------------------
    me = probs.mean(dim=0)                                        # mean prob
    fe = counts.to(torch.float32) / (t * k)                       # routed frac
    load_balance = e * torch.sum(me * fe)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    dropped = 1.0 - keep.to(torch.float32).mean()
    aux = {"moe_load_balance": cfg.load_balance_coef * load_balance,
           "moe_z_loss": cfg.router_z_coef * z_loss,
           "moe_drop_fraction": dropped}
    return y.reshape(b, l, d), aux
