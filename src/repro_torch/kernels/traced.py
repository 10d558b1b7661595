"""The card's kernels as PyTorch operators, for a traced step.

The production dry run (``launch.dryrun``) runs the card's path on fake
tensors laid out as DTensors over a fake process group. Each kernel
launcher it reaches is marked ``@kernel(name, schema)``, which makes it
the CUDA implementation of the operator ``repro_torch::<name>``
(``torch.library.custom_op``) with

  * a fake (``register_fake``): the card kernel's outputs, with their
    shapes and dtypes and no arithmetic (``FAKES[name].outputs``);
  * its DTensor layouts (``register_sharding``): the placements the
    kernel takes on one mesh dim (``FAKES[name].rules``), from which
    DTensor picks the cheapest and redistributes the inputs to it;
  * its price (``FAKES[name].cost``): the kernel's own flops and bytes,
    which ``ecm.step_cost`` reads by the operator's name.

A call with plain tensors launches as it always did, with no dispatcher
on the way (an operator adds about ten microseconds of host time a call,
``tools/op_dispatch_cost.py``, and a decode step makes hundreds of
kernel calls); a call with a fake tensor or a DTensor goes through the
operator. The operators are registered on
the first such call. A launcher with no fake raises for a traced call
(``check_real``), so a fake tensor never reaches ctypes and never takes
the plain twin.

Data-dependent work (the paged walks' live blocks) is priced as every
table slot live: a traced step has no lengths, and the dry run's decode
cells fill every slot's context.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import Callable

import torch

LIBRARY = "repro_torch"
_PLAIN = (torch.Tensor, torch.nn.Parameter)


def _kinds():
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    return FakeTensor, DTensor


def active(*tensors) -> bool:
    """True when any tensor is a fake tensor or a DTensor: the call is
    traced, not launched."""
    odd = [t for t in tensors if t is not None and type(t) not in _PLAIN]
    return bool(odd) and any(isinstance(t, _kinds()) for t in odd)


_CARD = [False]


@contextlib.contextmanager
def card():
    """Within this context a fake tensor takes the card's path whatever
    its device (``on_card``): the dry run traces on fake CPU tensors,
    since autograd's engine and C++ indexing need a CUDA runtime for a
    CUDA one."""
    _CARD.append(True)
    try:
        yield
    finally:
        _CARD.pop()


def on_card(t) -> bool:
    """Whether ``t`` takes the card's path: a CUDA tensor, or a traced
    one (a fake tensor or a DTensor of them) inside ``card()``."""
    return t.is_cuda or (_CARD[-1] and active(t))


def check_real(name: str, *tensors) -> None:
    """Raise for a traced call of a kernel that has no fake."""
    if active(*tensors):
        raise RuntimeError(f"{name}: a traced call (fake tensor or "
                           f"DTensor) reached a kernel with no fake; "
                           f"give it one in kernels.traced.FAKES")


@dataclass(frozen=True)
class Fake:
    """Of one operator, each called with its schema's arguments in order:
    ``outputs``: the kernel's outputs; ``cost``: (tensor-core flops,
    CUDA-core flops, bytes) of one call on local tensors; ``scratch``:
    the bytes of the kernel's scratch, live beside its outputs during the
    call; ``rules``: ``register_sharding``'s strategies on one mesh dim,
    (output placements, a placement or None per argument) pairs, the
    all-replicated one first. DTensor takes the cheapest, the first of a
    tie, and moving a replicated tensor to a split costs it nothing: so
    a split of rows, batch or heads is offered only where an input has
    it already (40 heads split 16 ways would be uneven)."""
    outputs: Callable
    cost: Callable
    rules: Callable
    scratch: Callable = lambda *a: 0


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _r():
    from torch.distributed.tensor import Replicate
    return Replicate()


def _s(dim: int):
    from torch.distributed.tensor import Shard
    return Shard(dim)


def _opt(t, placement):
    """An optional tensor argument's placement (None for None)."""
    return None if t is None else placement


def _splits(dims, *specs) -> list:
    """The splits along ``dims`` that the inputs' specs already have, each
    once, passed through as they are (a strided one too, left where a
    split dim was flattened into the rows)."""
    out = {}
    for spec in specs:
        for p in spec.placements:
            if p.is_shard() and p.dim in dims:
                out.setdefault(str(p), p)
    return list(out.values())


# ------------------------------------------------------------ the fakes ----

def _norm_outputs(x, weight, bias, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _norm_cost(x, weight, bias, eps):
    layer = bias is not None
    d = x.shape[-1]
    m = x.numel() // d
    return 0, m * d * (6 if layer else 4), \
        2 * m * d * x.element_size() + 4 * d * (2 if layer else 1)


def _norm_rules(x, weight, bias, eps):
    """Rows split as x's are; the normed dim whole."""
    return [([p], [p, _r(), _opt(bias, _r()), None])
            for p in [_r()] + _splits(range(x.ndim - 1), x)]


def _gemm_outputs(x, w, plan_batch, route):
    shape = tuple(x.shape[:-1]) + (w.shape[-1],)
    return torch.empty(shape, dtype=torch.float32, device=x.device)


def _gemm_cost(x, w, plan_batch, route):
    from repro_torch.kernels import invariant_gemm as ig
    k, n = x.shape[-1], w.shape[-1]
    b = math.prod(w.shape[:-2])
    m = x.numel() // (b * k)
    return ig.flops(m, k, n, b), 0, ig.bytes_moved(m, k, n, b)


def _gemm_rules(x, w, plan_batch, route):
    """[.., M, K] x [K, N] or [B.., M, K] x [B.., K, N]: rows (or batch)
    split with x (and w's batch), N with w, K on both sides leaves a
    partial sum."""
    from torch.distributed.tensor import Partial
    nd, nb = x.ndim, w.ndim - 2
    return [([_r()], [_r(), _r(), None, None])] + [
        ([p], [p, p, None, None]) for p in _splits(range(nb), x, w)] + [
        ([p], [p, _r(), None, None]) for p in _splits(range(nb, nd - 1), x)
    ] + [
        ([_s(nd - 1)], [_r(), _s(w.ndim - 1), None, None]),
        ([Partial()], [_s(nd - 1), _s(w.ndim - 2), None, None])]


def _head_outputs(h, w, tied):
    v = w.shape[0] if tied else w.shape[1]
    return torch.empty(tuple(h.shape[:-1]) + (v,), dtype=torch.float32,
                       device=h.device)


def _head_cost(h, w, tied):
    from repro_torch.kernels import serving_head as sh
    v, d = w.shape if tied else w.shape[::-1]
    m = h.numel() // d
    return 0, 2 * m * d * v, sh.bytes_moved(m, d, v, h.element_size())


def _head_rules(h, w, tied):
    """Rows split with h, the vocabulary with W; d whole (``tied`` is an
    int so that DTensor's cache of layouts tells the two forms apart)."""
    return [([p], [p, _r(), None])
            for p in [_r()] + _splits(range(h.ndim - 1), h)] + [
        ([_s(h.ndim - 1)], [_r(), _s(0 if tied else 1), None])]


def _paged_outputs(q, kpool, vpool, block_table, lens, q_offsets, kscale,
                   vscale, scale):
    b, w, hq, _ = q.shape
    return torch.empty((b, w, hq, vpool.shape[-1]), dtype=q.dtype,
                       device=q.device)


def _paged_scratch(q, kpool, vpool, block_table, lens, q_offsets, kscale,
                   vscale, scale):
    from repro_torch.kernels import paged_attention as pa
    b, w, hq, _ = q.shape
    hkv = kpool.shape[2]
    return 4 * pa.scratch_floats(b, hkv, w * (hq // hkv), vpool.shape[-1],
                                 block_table.shape[1])


def _paged_cost(q, kpool, vpool, block_table, lens, q_offsets, kscale,
                vscale, scale):
    b, w, hq, d = q.shape
    mb, bs = block_table.shape[1], kpool.shape[1]
    dv = vpool.shape[-1]
    per_block = _nbytes(kpool[0], vpool[0]) + (
        2 * kscale[0].numel() * 4 if kscale is not None else 0)
    nbytes = (_nbytes(q) + b * w * hq * dv * q.element_size()
              + b * mb * per_block + _nbytes(block_table) + 2 * b * 4)
    return 0, 2 * (d + dv) * b * mb * bs * w * hq, nbytes


def _pool_rules(q, n_q: int, pools: list, head_dims: list, tail: int):
    """The paged walks' layouts on one mesh dim, over ``n_q`` query
    tensors (the first ``q``), ``pools`` (then the table, lengths and
    offsets, then one scale per pool, None where absent) and ``tail``
    non-tensor arguments: where q's batch or the pools' blocks are split,
    the batch split with the pools' blocks (each rank's slots in its own
    blocks: the identity tables of ``padded_num_blocks``) or with whole
    pools; where q's heads are split and each pool with heads has its
    heads split (``head_dims``: each pool's head dim, None for a pool
    without heads, which stays whole), the heads split with the pools'."""
    scales = [p is not None for p in pools[len(head_dims):]]
    npool = len(head_dims)
    split = {str(p) for p in q.placements if p.is_shard()}
    batch = str(_s(0)) in split or bool(_splits((0,), pools[0]))
    heads = str(_s(2)) in split and all(
        d is None or str(_s(d)) in {str(p) for p in pools[j].placements}
        for j, d in enumerate(head_dims))

    def layout(q_pl, pool_pl, per_b):
        return ([q_pl] * n_q + [pool_pl(j) for j in range(npool)]
                + [per_b] * 3
                + [pool_pl(j) if s else None for j, s in enumerate(scales)]
                + [None] * tail)
    out = [([_r()], layout(_r(), lambda j: _r(), _r()))]
    if batch:
        out += [([_s(0)], layout(_s(0), lambda j: _s(0), _s(0))),
                ([_s(0)], layout(_s(0), lambda j: _r(), _s(0)))]
    if heads:
        out.append(([_s(2)], layout(
            _s(2), lambda j: _r() if head_dims[j] is None
            else _s(head_dims[j]), _r())))
    return out


def _paged_rules(q, kpool, vpool, block_table, lens, q_offsets, kscale,
                 vscale, scale):
    return _pool_rules(q, 1, [kpool, vpool, kscale, vscale], [2, 2], 1)


def _latent_outputs(q_lat, q_rope, ck_pool, kr_pool, block_table, lens,
                    q_offsets, ck_scale, kr_scale, scale):
    return torch.empty(q_lat.shape, dtype=torch.float32, device=q_lat.device)


def latent_scratch_floats(b: int, rows: int, c: int, mb: int) -> int:
    """``repro_paged_latent_attention_scratch`` of
    ``csrc/paged_latent_attention.cu``: a chunk of up to 32 partitions'
    partials per split launch, plus one merged partial when the table
    takes more than one chunk."""
    from repro_torch.kernels import paged_attention as pa
    nparts = pa.partitions(mb)
    npa = min(nparts, 32)
    stride = ((3 * rows + 3) & ~3) + 2 * rows * c
    return b * stride * (npa + (1 if nparts > npa else 0))


def _latent_scratch(q_lat, q_rope, ck_pool, kr_pool, block_table, lens,
                    q_offsets, ck_scale, kr_scale, scale):
    b, w, h, c = q_lat.shape
    return 4 * latent_scratch_floats(b, w * h, c, block_table.shape[1])


def _latent_cost(q_lat, q_rope, ck_pool, kr_pool, block_table, lens,
                 q_offsets, ck_scale, kr_scale, scale):
    b, w, h, c = q_lat.shape
    r = q_rope.shape[-1]
    mb, bs = block_table.shape[1], ck_pool.shape[1]
    keys = b * mb * bs * w - b * w * (w - 1) // 2

    def passes(a_dtype):
        pa_, pb_ = (3 if dt == torch.float32 else 1
                    for dt in (a_dtype, ck_pool.dtype))
        return 6 if pa_ == pb_ == 3 else pa_ * pb_
    flops = keys * h * (2 * c * (passes(q_lat.dtype) + passes(torch.float32))
                        + 2 * r * passes(q_rope.dtype))
    per_block = _nbytes(ck_pool[0], kr_pool[0]) + (
        2 * ck_scale[0].numel() * 4 if ck_scale is not None else 0)
    nbytes = (_nbytes(q_lat, q_rope) + q_lat.numel() * 4 + b * mb * per_block
              + _nbytes(block_table) + 2 * b * 4)
    return flops, 0, nbytes


def _latent_rules(q_lat, q_rope, ck_pool, kr_pool, block_table, lens,
                  q_offsets, ck_scale, kr_scale, scale):
    return _pool_rules(q_lat, 2, [ck_pool, kr_pool, ck_scale, kr_scale],
                       [None, None], 1)


_FLOPS_PER_OUTPUT = {"max": 1, "maxabs": 1, "sum": 6, "sumsq": 7, "dot": 8}


def _reduce_outputs(x, y, outputs, unroll, block_elems, compensated):
    from repro_torch.kernels import engine
    return torch.empty((len(engine.ALL_OUTPUTS), x.shape[0]),
                       dtype=torch.float32, device=x.device)


def _reduce_cost(x, y, outputs, unroll, block_elems, compensated):
    from repro_torch.kernels import engine
    b, n = x.shape
    return 0, b * n * sum(_FLOPS_PER_OUTPUT[o] for o in outputs), \
        engine.bytes_moved(b, n, 1 if y is None else 2, len(outputs))


def _reduce_rules(x, y, outputs, unroll, block_elems, compensated):
    """(B, N) rows: x's row split passes through to the outputs' columns,
    N is whole."""
    rows = [(_s(1), _s(0))] if _splits((0,), x) else []
    return [([p], [q, _opt(y, q), None, None, None, None])
            for p, q in [(_r(), _r())] + rows]


def _acc_outputs(acc_sum, acc_carry, update):
    return None


def _acc_cost(acc_sum, acc_carry, update):
    from repro_torch.kernels import kahan_acc as ka
    n = acc_sum.numel()
    return 0, 8 * n, ka.bytes_moved(n, update.element_size())


def _acc_rules(acc_sum, acc_carry, update):
    """Elementwise, in place: the three laid out as the accumulator is,
    which must not move (a moved copy would take the writes). Its one
    placement on every mesh dim is the one strategy; mixed ones raise
    (the optimizer runs it per shard, ``sharding.elementwise_per_shard``)."""
    pl = {str(p): p for p in acc_sum.placements}
    if len(pl) != 1:
        raise NotImplementedError(
            f"kahan_acc on an accumulator laid out {acc_sum.placements}: "
            f"run it on each rank's shard")
    p, = pl.values()
    return [([], [p] * 3)]


FAKES: dict[str, Fake] = {
    "row_norm": Fake(_norm_outputs, _norm_cost, _norm_rules),
    "invariant_gemm": Fake(_gemm_outputs, _gemm_cost, _gemm_rules),
    "serving_head": Fake(_head_outputs, _head_cost, _head_rules),
    "paged_attention": Fake(_paged_outputs, _paged_cost, _paged_rules,
                            _paged_scratch),
    "paged_latent_attention": Fake(_latent_outputs, _latent_cost,
                                   _latent_rules, _latent_scratch),
    "fused_reduce": Fake(_reduce_outputs, _reduce_cost, _reduce_rules),
    "kahan_acc": Fake(_acc_outputs, _acc_cost, _acc_rules),
}


# ------------------------------------------------------------ operators ----

_LAUNCHERS: dict[str, tuple] = {}    # name -> (launcher, schema, mutates)
_OPS: dict[str, Callable] = {}


def op(name: str):
    """The operator ``repro_torch::<name>``, registered on first use."""
    got = _OPS.get(name)
    if got is not None:
        return got
    from torch.distributed.tensor.experimental import register_sharding
    launch, schema, mutates = _LAUNCHERS[name]
    impl = torch.library.custom_op(f"{LIBRARY}::{name}", launch,
                                   mutates_args=mutates,
                                   device_types="cuda", schema=schema)
    # looked up at each call: a test may swap a fake's outputs
    impl.register_fake(lambda *a: FAKES[name].outputs(*a))
    register_sharding(impl._opoverload)(lambda *a: FAKES[name].rules(*a))
    _OPS[name] = impl._opoverload
    return _OPS[name]


def kernel(name: str, schema: str, *, mutates: tuple = ()):
    """Mark a launcher (every argument positional, in ``schema``'s order)
    as the CUDA implementation of ``repro_torch::<name>``: a call with a
    fake tensor or a DTensor among its tensors goes through the
    operator, any other call launches directly. A launcher that writes
    ``mutates`` in place returns None."""
    def wrap(launch):
        _LAUNCHERS[name] = (launch, schema, mutates)

        @functools.wraps(launch)
        def entry(*args):
            if active(*(a for a in args if isinstance(a, torch.Tensor))):
                return op(name)(*args)
            return launch(*args)
        return entry
    return wrap


def price(name: str, args) -> tuple:
    """(tensor-core flops, CUDA-core flops, bytes, scratch bytes) of one
    call of ``repro_torch::<name>`` on local tensors."""
    fake = FAKES[name]
    return (*fake.cost(*args), fake.scratch(*args))
