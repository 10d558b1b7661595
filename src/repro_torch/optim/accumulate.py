"""Microbatch gradient accumulation, naive and Kahan-compensated (twin of
``repro.optim.accumulate``).

The framework-scale instance of the paper's kernel: accumulating G
microbatch gradients is a length-G summation per parameter element. The
compensated accumulator keeps a (sum, carry) pair per element and folds
each microbatch's gradient in with one Neumaier step: for every f32
leaf that step is ``kernels.ops.kahan_accumulate``, the B7 kernel on the
card (its plain twin on the CPU), in place on the accumulator, bitwise
``KahanState.add``. The accumulators are f32 by construction, so B7's
f32-only rule always holds here; the update may be f32 or bf16.

``gradient_stats`` is the clip norm and max|g| in one pass of the
reduction engine per leaf (``ops.fused_reduce``: B2f on the card), the
per-leaf partials merged with a Neumaier step on the device (no host
sync per leaf).

``value_and_grad`` stands in for ``jax.value_and_grad``: each leaf is
detached into a fresh autograd leaf, the loss runs on that tree, and
``torch.autograd.grad`` returns the gradient tree. A DTensor leaf's
gradient is laid out as the leaf by a hook on it, which runs as soon as
the gradient is whole (a layer's weights once its backward is done), so
no rank holds a gathered weight's partial gradient to the end of the
backward. (A node between the leaf and its uses would run only at the
backward's end: the engine runs the ready node made last first.)
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import kahan
from repro_torch.core.kahan import (KahanState, tree_leaves, tree_map,
                                    tree_unflatten)
from repro_torch.kernels import ops

Tree = Any


def value_and_grad(loss_fn: Callable, params: Tree, batch: dict
                   ) -> tuple[tuple[torch.Tensor, dict], Tree]:
    """((loss, metrics), grads) of ``loss_fn(params, batch)``, which
    returns (loss, metrics); every leaf of ``params`` is differentiated."""
    from torch.distributed.tensor import DTensor
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    for p in leaves:
        if isinstance(p, DTensor):
            p.register_hook(_laid_as(p))
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_unflatten(params, grads))


def _laid_as(p):
    """A hook laying a gradient out as the DTensor ``p``."""
    mesh, placements = p.device_mesh, p.placements

    def hook(g):
        return g if g.placements == placements else \
            g.redistribute(mesh, placements)
    return hook


def accumulate_gradients(loss_fn: Callable, params: Tree, batches: dict,
                         *, kahan: bool = True
                         ) -> tuple[torch.Tensor, Tree, dict]:
    """Over the leading microbatch dim of every leaf of ``batches``;
    returns (mean loss, mean grads, summed metrics)."""
    n_micro = next(iter(batches.values())).shape[0]
    g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    zero = torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(params)[0].device)
    if kahan:
        g_carry = tree_map(torch.zeros_like, g_sum)
        l_acc = KahanState({"loss": zero}, {"loss": zero})
    else:
        l_acc = {"loss": zero}
    metrics = None
    for i in range(n_micro):
        micro = {k: v[i] for k, v in batches.items()}
        (loss, m), grads = value_and_grad(loss_fn, params, micro)
        if kahan:
            for s, c, g in zip(tree_leaves(g_sum), tree_leaves(g_carry),
                               tree_leaves(grads)):
                ops.kahan_accumulate(s, c, g.contiguous())
            l_acc = l_acc.add({"loss": loss})
        else:
            g_sum = tree_map(lambda a, g: a + g.to(a.dtype), g_sum, grads)
            l_acc = {"loss": l_acc["loss"] + loss}
        metrics = m if metrics is None else {k: metrics[k] + m[k]
                                             for k in metrics}
    if kahan:
        grads = KahanState(g_sum, g_carry).value()
        loss = l_acc.value()["loss"] / n_micro
    else:
        grads = g_sum
        loss = l_acc["loss"] / n_micro
    grads = tree_map(lambda g: g / n_micro, grads)
    return loss, grads, metrics


def gradient_stats(grads: Tree) -> dict[str, torch.Tensor]:
    """{'global_norm', 'max_abs'} in ONE streaming pass per leaf: the
    reduction engine's compensated sumsq and running max|g| share the
    read, and the per-leaf partials merge with a Neumaier step."""
    leaves = tree_leaves(grads)
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    s = c = max_abs = zero
    for g in leaves:
        st = ops.fused_reduce(g, outputs=("sumsq", "maxabs"))
        s, c = kahan.neumaier_step(s, c, st["sumsq"].to(torch.float32))
        max_abs = torch.maximum(max_abs, st["maxabs"].to(torch.float32))
    return {"global_norm": torch.sqrt(s + c), "max_abs": max_abs}


def split_microbatches(batch: dict, n_micro: int) -> dict:
    """[B, ...] -> [n_micro, B / n_micro, ...] on every leaf."""
    def split(x):
        b = x.shape[0]
        assert b % n_micro == 0, (b, n_micro)
        return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    return {k: split(v) for k, v in batch.items()}
