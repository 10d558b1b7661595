"""AdamW with an optional Kahan-compensated parameter update (twin of
``repro.optim.adamw``).

The compensated variant is the paper's algorithm at the training-step
scale: late in training ``lr·u`` falls below eps·|param| and a naive
``p -= lr·u`` drops it, the failure of a long scalar accumulation. A
per-parameter carry (Neumaier) keeps it at +4 bytes per parameter.

On an f32 base (the parameter, or its f32 master) the carry's Neumaier
step is ``kernels.ops.kahan_accumulate``: the B7 kernel on a CUDA
tensor, its plain twin on a CPU one, both bitwise the reference's
``neumaier_step``. It writes the base and the carry IN PLACE, so
``update`` consumes the trees it is given, as the reference's jitted
step donates them. A base of another dtype takes the functional
``core.kahan.neumaier_step`` (B7 takes f32 accumulators only).

Trees are the port's parameter trees (nested dicts and per-layer
lists); ``count`` and every scalar stay on the parameters' device.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import kahan
from repro_torch.core.kahan import tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels import ops

Tree = Any


class AdamWState(NamedTuple):
    count: torch.Tensor           # 0-d int32
    m: Tree
    v: Tree
    carry: Tree | None            # Kahan carry per param (compensated)
    master: Tree | None = None    # f32 master copy (mixed precision)


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    kahan: bool = False
    # mixed precision: params in bf16, updates applied to an f32 master
    master_weights: bool = False


def init(params: Tree, cfg: AdamWConfig) -> AdamWState:
    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    device = tree_leaves(params)[0].device
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        m=zeros(), v=zeros(), carry=zeros() if cfg.kahan else None,
        master=(tree_map(lambda p: p.to(torch.float32, copy=True), params)
                if cfg.master_weights else None))


def update(grads: Tree, state: AdamWState, params: Tree, cfg: AdamWConfig,
           lr_scale: torch.Tensor | float = 1.0) -> tuple[Tree, AdamWState]:
    """Returns (new_params, new_state)."""
    count = state.count + 1
    b1, b2 = cfg.b1, cfg.b2
    cf = count.to(torch.float32)
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf
    neg_lr = -(cfg.lr * lr_scale)

    def upd(p, g, m, v, c, w):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        base = w if w is not None else p
        step = (mh / (torch.sqrt(vh) + cfg.eps)
                + cfg.weight_decay * base.to(torch.float32))
        delta = (neg_lr * step).to(base.dtype)
        if c is None:
            new_base, new_c = base + delta, None
        elif base.dtype == torch.float32:
            new_base, new_c = ops.kahan_accumulate(base, c, delta)
        else:
            new_base, new_c = kahan.neumaier_step(base, c.to(base.dtype),
                                                  delta)
            new_c = new_c.to(torch.float32)
        # a master's param is a copy even at f32 (B7 writes the master)
        return (new_base.to(p.dtype, copy=w is not None), m, v, new_c,
                new_base if w is not None else None)

    n = len(tree_leaves(params))
    leaves_c = (tree_leaves(state.carry) if state.carry is not None
                else [None] * n)
    leaves_w = (tree_leaves(state.master) if state.master is not None
                else [None] * n)
    # the update is elementwise: a DTensor leaf's runs on each rank's
    # shard (its state and gradient laid out as the leaf)
    from repro_torch.distributed.sharding import (elementwise_per_shard,
                                                  gathered)
    bc1, bc2, neg_lr = gathered(bc1), gathered(bc2), gathered(neg_lr)
    out = [elementwise_per_shard(upd, *args) for args in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
        tree_leaves(state.v), leaves_c, leaves_w)]

    def tree(i):
        return tree_unflatten(params, [o[i] for o in out])
    return tree(0), AdamWState(
        count=count, m=tree(1), v=tree(2),
        carry=tree(3) if state.carry is not None else None,
        master=tree(4) if state.master is not None else None)


def global_norm(tree: Tree, *, fused: bool = False) -> torch.Tensor:
    """Global L2 norm of a tree. ``fused=True`` streams each leaf once
    through the reduction engine's compensated sum of squares (B2f),
    ``accumulate.gradient_stats``; the default is the plain form."""
    if fused:
        from repro_torch.optim import accumulate
        return accumulate.gradient_stats(tree)["global_norm"]
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float, *,
                        fused: bool = False,
                        norm: torch.Tensor | None = None
                        ) -> tuple[Tree, torch.Tensor]:
    """Clip to ``max_norm``. Pass a precomputed ``norm`` (e.g. from
    ``accumulate.gradient_stats``) to avoid recomputing it."""
    if norm is None:
        norm = global_norm(grads, fused=fused)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def warmup_cosine(step, *, warmup: int, total: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """LR multiplier in [min_ratio, 1] (f32, on ``step``'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup, 1)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                             * progress))
    return torch.where(step < warmup, warm, cos)
