"""Compensated (Kahan) cross-device reductions over ``torch.distributed``
(twin of ``repro.distributed.collectives``): the paper's algorithm
applied across ranks instead of across SIMD lanes.

A gradient all-reduce over n ranks is a length-n summation per element,
the structure the paper compensates inside one core. A library
all-reduce sums in an order of its own with no compensation; these carry
a (sum, carry) pair instead:

  * n = 2 (the pods' axis): one exchange of the raw shards and a local
    Neumaier add. The payload is a plain exchange's: the compensation is
    free.
  * n > 2: a ring reduce-scatter with a (sum, carry) payload, then an
    all-gather: 2 f32 streams per hop, ~1.5x a plain ring's bytes.

Every function runs on each rank of ``group`` (a process group, e.g.
``mesh.get_group("pod")``; None is the default group) with that rank's
local tensor, in the reference's order of operations: the exchanges go
to rank + 1 and come from rank - 1 of the group, as the reference's
``ppermute`` ring does, so the results are the reference's bits. A CUDA
tensor travels over NCCL and a CPU tensor over gloo: a tensor whose
device does not match its group's backend raises, nothing is staged
through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import kahan


def _check_device(x: torch.Tensor, group) -> None:
    backend = str(dist.get_backend(group)).lower()
    want = "nccl" if x.is_cuda else "gloo"
    if backend != want:
        raise RuntimeError(
            f"a {x.device.type} tensor travels over {want}, but this group's "
            f"backend is {backend}: give the collective a group of its "
            f"device's backend")


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """What rank - 1 of ``group`` holds: ``x`` goes to rank + 1 (one
    ``batch_isend_irecv``), the reference's ``ppermute`` over the ring
    i -> i + 1."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n) if group is not None \
        else (me + 1) % n
    prv = dist.get_global_rank(group, (me - 1) % n) if group is not None \
        else (me - 1) % n
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, nxt, group),
        dist.P2POp(dist.irecv, out, prv, group)])
    for r in reqs:
        r.wait()
    return out


def kahan_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The compensated sum of every rank's ``x`` over ``group``, on every
    rank."""
    _check_device(x, group)
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if n == 2:
        other = ring_shift(x, group)
        s, c = kahan.neumaier_step(x, torch.zeros_like(x), other)
        return s + c
    return _kahan_ring_rs_ag(x, group, n)


def _kahan_ring_rs_ag(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Ring reduce-scatter with a (sum, carry) payload, then all-gather."""
    idx = dist.get_rank(group)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    acc_s = flat.reshape(n, -1).clone()                # [n, m]
    acc_c = torch.zeros_like(acc_s)
    for t in range(n - 1):
        send_idx = (idx - t) % n
        recv = ring_shift(torch.stack([acc_s[send_idx], acc_c[send_idx]]),
                          group)
        recv_idx = (idx - t - 1) % n
        acc_s[recv_idx], acc_c[recv_idx] = kahan.combine(
            acc_s[recv_idx], acc_c[recv_idx], recv[0], recv[1])
    own = (idx + 1) % n                                 # fully reduced chunk
    mine = acc_s[own] + acc_c[own]
    gathered = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(gathered, mine, group=group)        # [n, m] by rank
    # rank i holds chunk (i + 1) % n: roll back into chunk order
    out = torch.roll(torch.stack(gathered), 1, dims=0).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)


def naive_ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Uncompensated ring (the accuracy baseline): the same exchanges,
    plain adds."""
    _check_device(x, group)
    n = dist.get_world_size(group)
    acc, buf = x, x
    for _ in range(n - 1):
        buf = ring_shift(buf, group)
        acc = acc + buf
    return acc


def pre_reduce_stats(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Local-shard statistics before a cross-rank reduction, in one fused
    pass (``ops.fused_reduce``, B2f on the card): the compensated sum,
    the l2 norm from the compensated sum of squares, and max|x|."""
    from repro_torch.kernels import ops
    st = ops.fused_reduce(x, outputs=("sum", "sumsq", "maxabs"))
    return {"sum": st["sum"], "l2": torch.sqrt(st["sumsq"]),
            "maxabs": st["maxabs"]}


def make_all_reduce_fn(mesh, axis: str, *, compensated: bool = True):
    """The all-reduce over one mesh axis of a tree of each rank's local
    tensors (the pods' gradient reduction): ``kahan_all_reduce`` or the
    naive ring, leaf by leaf, on the axis's group of ``mesh`` (a
    ``DeviceMesh``)."""
    reduce_one = kahan_all_reduce if compensated else naive_ring_all_reduce
    group = mesh.get_group(axis)

    def tree_reduce(tree):
        return kahan.tree_map(lambda x: reduce_one(x, group), tree)
    return tree_reduce
