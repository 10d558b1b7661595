"""GPipe-style pipeline parallelism over a "stage" mesh axis (twin of
``repro.distributed.pipeline``).

SPMD: every stage runs the same program, and activations travel from
stage s to stage s + 1 once per clock tick. For M microbatches and S
stages the schedule runs M + S - 1 ticks (GPipe's bubble: efficiency
M / (M + S - 1)). The exchange is an autograd function whose backward
sends the gradient the other way, so a train step is ``loss.backward()``
through the pipeline: each stage's gradient lands in its own slice of
the stacked parameters.

Every tick keeps the reference's data flow, so every exchange has its
backward on every stage: stage 0 takes the microbatch instead of what it
received (the received zeros stay in the graph), and every stage's
output enters the output buffer, masked off where it is not the last
stage's output of a microbatch. The outputs are then broadcast from the
last stage; in the backward only the last stage's copy carries the
gradient, as under the reference's mask-and-psum.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _neighbours(group) -> tuple[int | None, int | None]:
    """Global ranks of the previous and the next stage (None at the
    ends: the stages form a line, not a ring)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)

    def glob(i):
        return dist.get_global_rank(group, i) if group is not None else i
    return (glob(me - 1) if me > 0 else None,
            glob(me + 1) if me < n - 1 else None)


def _exchange(send: torch.Tensor, to, frm, group) -> torch.Tensor:
    """Send ``send`` to rank ``to`` and receive a tensor of its shape from
    ``frm`` (zeros when ``frm`` is None)."""
    out = torch.zeros_like(send)
    ops = []
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, out, frm, group))
    if ops:
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    return out


class _Shift(torch.autograd.Function):
    """Stage s's tensor to stage s + 1; the gradient back to stage s."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        prv, nxt = _neighbours(group)
        return _exchange(x, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        prv, nxt = _neighbours(ctx.group)
        return _exchange(g, prv, nxt, ctx.group), None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every stage; the gradient stays with
    the last stage's copy."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.last = dist.get_rank(group) == n - 1
        src = dist.get_global_rank(group, n - 1) if group is not None \
            else n - 1
        out = x.detach().clone().contiguous()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def make_pipeline_fn(stage_fn: Callable, mesh, axis: str = "stage"):
    """The SPMD GPipe forward over ``mesh``'s (a ``DeviceMesh``) ``axis``:
    ``run(stacked_params, x_micro)`` on every rank, with ``stacked_params``
    a tree of tensors whose leading dim is the stage (each rank takes its
    own slice) and ``x_micro`` [M, ...] the microbatches (the same on
    every rank). Returns the last stage's outputs [M, ...] on every
    rank."""
    group = mesh.get_group(axis)
    s_total = dist.get_world_size(group)

    def run(stacked_params, x_micro):
        from repro_torch.core.kahan import tree_map
        s_idx = dist.get_rank(group)
        params = tree_map(lambda p: p[s_idx], stacked_params)
        m = x_micro.shape[0]
        prev_out = torch.zeros_like(x_micro[0])
        outputs = torch.zeros_like(x_micro)
        first = torch.tensor(s_idx == 0, device=x_micro.device)
        for t in range(m + s_total - 1):
            recv = _Shift.apply(prev_out, group)
            x_in = torch.where(first, x_micro[min(t, m - 1)], recv)
            y = stage_fn(params, x_in)
            out_idx = t - (s_total - 1)
            valid = s_idx == s_total - 1 and 0 <= out_idx < m
            slot = min(max(out_idx, 0), m - 1)
            keep = torch.tensor(valid, device=x_micro.device)
            row = torch.where(keep, y, outputs[slot])
            outputs = torch.cat([outputs[:slot], row[None],
                                 outputs[slot + 1:]])
            prev_out = y
        return _FromLast.apply(outputs, group)

    return run
