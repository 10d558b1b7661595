"""The train step and the one-shot greedy serve steps (twin of
``repro.train.steps``).

``build_prefill_step`` / ``build_serve_step`` are the reference's
one-shot server for every family: a batch prefilled at once into fresh
identity-table caches, then greedy decode steps of the whole batch (the
hybrid and audio families serve only this way; the serving engine takes
the lm families in chunks). The decode step updates the caches in place
and returns them.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.kahan import tree_leaves
from repro_torch.distributed import sharding
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.optim import accumulate, adamw


def build_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *,
                     clip_norm: float = 1.0,
                     schedule: Callable | None = None,
                     n_microbatches: int = 1,
                     kahan_grad_acc: bool = True,
                     fused_grad_stats: bool = False) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    ``batch`` holds tensors on the parameters' device; ``step`` is an int
    or a 0-d tensor. ``n_microbatches > 1`` accumulates the microbatch
    gradients (Kahan: B7 per leaf per microbatch on the card).
    ``fused_grad_stats=True`` takes the clip norm from the reduction
    engine's compensated sumsq (B2f, one launch per leaf) and adds a
    ``grad_maxabs`` metric from the same pass. The update consumes
    ``params`` and ``opt_state`` (``adamw.update``).
    """
    loss_fn = api.loss_fn(cfg)

    def train_step(params, opt_state, batch, step):
        if n_microbatches > 1:
            micro = accumulate.split_microbatches(batch, n_microbatches)
            loss, grads, metrics = accumulate.accumulate_gradients(
                loss_fn, params, micro, kahan=kahan_grad_acc)
            metrics = {k: v / n_microbatches for k, v in metrics.items()}
        else:
            (loss, metrics), grads = accumulate.value_and_grad(
                loss_fn, params, batch)
        if fused_grad_stats:
            gstats = accumulate.gradient_stats(grads)
            grads, gnorm = adamw.clip_by_global_norm(
                grads, clip_norm, norm=gstats["global_norm"])
            metrics = dict(metrics, grad_maxabs=gstats["max_abs"])
        else:
            grads, gnorm = adamw.clip_by_global_norm(grads, clip_norm)
        device = tree_leaves(params)[0].device
        step = torch.as_tensor(step, dtype=torch.int32, device=device)
        lr_scale = schedule(step) if schedule is not None else 1.0
        new_params, new_state = adamw.update(grads, opt_state, params,
                                             opt_cfg, lr_scale)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       lr_scale=torch.as_tensor(lr_scale,
                                                dtype=torch.float32,
                                                device=device))
        return new_params, new_state, metrics

    return train_step


def build_prefill_step(cfg: ModelConfig, cache_size) -> Callable:
    """(params, batch) -> (next_tokens [B] int32, caches): the greedy
    argmax of the last position's logits (the first index of a tie, as
    ``jnp.argmax``)."""
    prefill = api.prefill_fn(cfg, cache_size)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, caches = prefill(params, batch)
        logits = sharding.unshard_dim(logits, -1)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return prefill_step


def build_serve_step(cfg: ModelConfig) -> Callable:
    """One greedy decode step: (params, caches, tokens [B, 1]) ->
    (next_tokens [B, 1] int32, caches), the caches updated in place."""
    decode = api.decode_fn(cfg)

    @torch.no_grad()
    def serve_step(params, caches, tokens):
        logits = sharding.unshard_dim(decode(params, tokens, caches), -1)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], caches

    return serve_step
