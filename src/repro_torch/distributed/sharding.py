"""Logical-axis sharding rules -> mesh specs, and their DTensor placements
(twin of ``repro.distributed.sharding``).

Parameters declare *logical* axes in their schema; a rules table maps
them to mesh axes per parallelism configuration, with the reference's
two invariants:

  * a mesh axis appears at most once per spec (the first logical axis
    wins: MoE weights [experts, embed, mlp] give "model" to experts, and
    the per-expert mlp dim stays replicated);
  * a dim is sharded only if its size divides the mesh axes' extent
    (vocab 50280 on a 16-way model axis stays replicated).

A spec is a tuple with one entry per tensor dim, as the reference's
``PartitionSpec``: None (replicated), a mesh axis name, or a tuple of
names (the dim split over several axes, the first outermost). Specs are
computed from the mesh's axis names and sizes alone, so every function
that makes one takes a ``DeviceMesh`` or a plain ``{axis: size}``
mapping. ``placements`` turns a spec into the DTensor placements of a
``DeviceMesh``; ``NamedSharding`` pairs the two.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass

import torch

from repro_torch.models import common

Spec = tuple

# default FSDP(data) x TP(model) rules; pods replicate params (pure DP).
DEFAULT_RULES: dict[str | None, str | tuple[str, ...] | None] = {
    "vocab": "model",
    "embed": "data",        # FSDP axis
    "embed_out": None,
    "q_heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "layers": None,
    None: None,
}

# shard parameters over pods too (FSDP across the pods' link)
POD_FSDP_RULES = dict(DEFAULT_RULES, embed=("pod", "data"))

# small models: replicate params, shard the batch over every mesh axis
PURE_DP_RULES = {k: None for k in DEFAULT_RULES}

# logical -> mesh rules for activations
ACT_RULES_DEFAULT: dict[str, str | tuple[str, ...] | None] = {
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_experts": "model",
    "act_embed": None,
    # the sequence-parallel residual (``ModelConfig.sp_residual``)
    "act_res_seq": "model",
}


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``)
    or of a mapping that already is one."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh)


def _axis_size(sizes: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(sizes[a] for a in axes)


def _entry(axes: tuple):
    """A spec entry: the axis name alone, or the tuple of several."""
    return axes if len(axes) > 1 else axes[0]


def spec_for_axes(logical_axes: tuple, mesh, shape: tuple,
                  rules: dict) -> Spec:
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, logical_axes):
        mesh_axes = rules.get(name, None)
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        mesh_axes = tuple(a for a in mesh_axes if a in sizes
                          and a not in used)
        if not mesh_axes or dim % _axis_size(sizes, mesh_axes) != 0:
            out.append(None)
            continue
        used.update(mesh_axes)
        out.append(_entry(mesh_axes))
    return tuple(out)


def param_specs(schema: dict, mesh, rules: dict | None = None) -> dict:
    """The spec tree of a parameter schema (the parameters' structure)."""
    rules = rules or DEFAULT_RULES
    axes = common.logical_axes_tree(schema)
    shapes = common.abstract_params(schema)

    def walk(ax, arr):
        if isinstance(arr, dict):
            return {k: walk(ax[k], arr[k]) for k in arr}
        return spec_for_axes(ax, mesh, tuple(arr.shape), rules)
    return walk(axes, shapes)


# ------------------------------------------------------------ placements --

def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements on ``mesh`` (a ``DeviceMesh``) of a tensor
    laid out by ``spec``: ``Shard(dim)`` on each mesh dim that splits a
    tensor dim, ``Replicate()`` on the rest. A dim split over several
    axes must name them in the mesh's order (the first outermost), which
    is how DTensor nests shards of one dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} is split over {axes}, "
                             f"not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A ``DeviceMesh`` and a spec: where each shard of a tensor lives."""
    mesh: object
    spec: Spec

    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


# ------------------------------------------------- activation constraints --

_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_act_sharding", default=None)


_PRODUCT_RULES: list = []


def register_product_rules() -> None:
    """DTensor sharding rules for the card's bf16 products with an f32
    result (``aten.mm.dtype`` / ``aten.bmm.dtype``, ``invariant_gemm``'s
    ``_Bf16Product`` / ``_Bf16BatchedProduct`` in training), which
    PyTorch gives none: those of ``mm`` / ``bmm``, per mesh dim. Once per
    process."""
    if _PRODUCT_RULES:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    rep = ([Replicate()], [Replicate(), Replicate(), None])

    @register_sharding(aten.mm.dtype)
    def _mm(x, w, out_dtype):
        return [rep, ([Shard(0)], [Shard(0), Replicate(), None]),
                ([Shard(1)], [Replicate(), Shard(1), None]),
                ([Partial()], [Shard(1), Shard(0), None])]

    @register_sharding(aten.bmm.dtype)
    def _bmm(x, w, out_dtype):
        return [rep, ([Shard(0)], [Shard(0), Shard(0), None]),
                ([Shard(1)], [Shard(1), Replicate(), None]),
                ([Shard(2)], [Replicate(), Shard(2), None]),
                ([Partial()], [Shard(2), Shard(1), None])]
    _PRODUCT_RULES.extend([_mm, _bmm])


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict | None = None):
    """Within this context ``shard_act`` lays DTensor activations out on
    ``mesh`` (a ``DeviceMesh``) by ``rules``, and a plain tensor that
    meets a DTensor in an op (a RoPE table, a mask) counts as replicated
    on its mesh, as a constant does under the reference's jit."""
    from torch.distributed.tensor.experimental import implicit_replication
    register_product_rules()
    token = _ACT_CTX.set((mesh, rules or ACT_RULES_DEFAULT))
    try:
        with implicit_replication():
            yield
    finally:
        _ACT_CTX.reset(token)


def shard_act(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Lay an activation out by its logical dim names: ``x`` itself
    unless an ``activation_sharding`` context is active and ``x`` is a
    DTensor, which is then redistributed to the names' spec. The
    reference's sites; the port's own layouts go through ``lay_out``."""
    return lay_out(x, *names)


def lay_out(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """``shard_act``'s layout, for the sites the port adds where DTensor
    would otherwise keep whatever layout an op left (the embeddings, the
    residual stream): XLA's sharding propagation infers those in the
    reference."""
    ctx = _ACT_CTX.get()
    if ctx is None or len(names) != x.ndim:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = spec_for_axes(tuple(names), mesh, tuple(x.shape), rules)
    return x.redistribute(mesh, placements(spec, mesh))


def reduce_partial(x: torch.Tensor, like: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """``x`` with its pending partial sums reduced: a DTensor that a
    product over a sharded dim left ``Partial`` comes back replicated on
    those mesh dims, in its own dtype (f32 after a product), so nothing
    rounds the partials before they are summed; on a mesh dim where the
    DTensor ``like`` (of x's shape) is split, split as it is (a
    reduce-scatter: a weight's gradient never whole on a rank). Anything
    else is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    want = (like.placements if isinstance(like, DTensor)
            else (Replicate(),) * len(x.placements))
    return x.redistribute(x.device_mesh, [
        (w if w.is_shard() else Replicate()) if p.is_partial() else p
        for p, w in zip(x.placements, want)])


def gathered(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on this rank as a plain tensor: a DTensor is gathered
    from every rank (differentiably) and its local tensor returned;
    anything else is returned as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def replicated_on(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``like``'s mesh when ``like`` is a
    DTensor and ``t`` is not (so its gradient comes back plain through
    ``from_local``), else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh,
                              [Replicate()] * like.device_mesh.ndim,
                              run_check=False)


class _GradAsForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        # a partial sum's gradient is the same on every rank
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.placements != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_laid_as_forward(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a DTensor); its gradient is laid out as ``x`` is before it
    flows on. A product's [B, L, N] output is a view of [B * L, N] rows:
    a gradient that came back split along L would merge into rows
    DTensor cannot reshape (a strided split)."""
    return _GradAsForward.apply(x)


def product_grad_layout(dy: torch.Tensor, x: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """The gradient dY [M, N] of a DTensor product x [M, K] @ w [K, N]
    laid out as the forward's output was: rows split where x's rows are,
    N where w's N is, the rest whole. Left to itself DTensor may split
    dY's rows over a mesh dim x's rows are whole on, and a later view
    of those rows back to [B, L, ...] then takes a wrong local shape."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(dy, DTensor) and isinstance(x, DTensor)
            and isinstance(w, DTensor)):
        return dy
    pl = [Shard(0) if a.is_shard() and a.dim == 0 else
          Shard(1) if b.is_shard() and b.dim == 1 else Replicate()
          for a, b in zip(x.placements, w.placements)]
    return dy.redistribute(dy.device_mesh, pl)


def elementwise_per_shard(fn, *tensors):
    """``fn(*tensors)`` for an elementwise ``fn`` whose tensors (None
    allowed) share the first's shape: a DTensor first runs ``fn`` on each
    rank's shards, the others laid out as it, and the outputs (None
    allowed) come back with its placements."""
    from torch.distributed.tensor import DTensor, Replicate
    x = tensors[0]
    if not isinstance(x, DTensor):
        return fn(*tensors)
    mesh, pl = x.device_mesh, x.placements

    def shard(t):
        if t is None:
            return None
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, pl).to_local()
    out = fn(*(shard(t) for t in tensors))
    return tuple(None if o is None else DTensor.from_local(
        o, mesh, pl, run_check=False, shape=x.shape, stride=x.stride())
        for o in out)


def per_shard(fn, tensors: tuple, maps: tuple, out_maps: tuple,
              whole: bool = True):
    """``fn(*tensors)``, on each rank's local tensors when the work is
    independent along the dims the first tensor (a DTensor) is split
    over. ``maps[i]`` maps the first tensor's dims to tensor i's (a dim
    it lacks stays whole there; None passes through), ``out_maps`` the
    same for each output. A split of the first tensor along a dim its
    map lacks, or ``whole`` False (``fn`` reads something else per row),
    leaves ``fn`` to run on the DTensors as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = tensors[0]
    if not whole or not isinstance(x, DTensor):
        return fn(*tensors)
    mesh, pl = x.device_mesh, x.placements
    if any(p.is_partial() or (p.is_shard() and p.dim not in maps[0])
           for p in pl):
        return fn(*tensors)

    def want(m):
        return [Shard(m[p.dim]) if p.is_shard() and p.dim in m
                else Replicate() for p in pl]

    def local(t, m):
        if t is None:
            return None
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, want(m)).to_local()
    out = fn(*(local(t, m) for t, m in zip(tensors, maps)))
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(DTensor.from_local(o, mesh, want(m), run_check=False)
                    for o, m in zip(outs, out_maps))
    return wrapped if isinstance(out, tuple) else wrapped[0]


def column_dims(w: torch.Tensor) -> list:
    """The mesh dims that split a DTensor's last dim (none for a plain
    tensor)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(w, DTensor):
        return []
    return [i for i, p in enumerate(w.placements)
            if p.is_shard() and p.dim == w.ndim - 1]


def gate_up_per_shard(w: torch.Tensor) -> torch.Tensor:
    """A fused gate/up DTensor weight [..., 2 F] whose last dim one mesh
    dim of n splits, relaid so that rank r holds [gate_r | up_r], the
    r-th of n slices of each half: the weight's own values, in an order
    where a product's output splits into gate and up on each rank alone.
    Rank r's local columns are the slices 2r and 2r + 1 of the 2n; an
    all-to-all over that mesh dim sends each to the rank whose half it
    belongs to (slice c to rank c mod n), so each rank moves its own
    shard once and no rank holds the whole weight; the gradient comes
    back the same way. The DTensor returned keeps the weight's
    placements and stands for that column order."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    (i,) = column_dims(w)
    mesh = w.device_mesh
    n, r = mesh.size(i), mesh.get_coordinate()[i]
    f = w.shape[-1] // 2 // n
    local = w.to_local().movedim(-1, 0)
    dest = [2 * r % n, (2 * r + 1) % n]
    if dest[1] < dest[0]:               # an odd n wraps the second slice
        local = torch.cat([local[f:], local[:f]])
    sent, got = [0] * n, [0] * n
    for d in dest:
        sent[d] += f
    got[r // 2] += f                    # gate_r, then up_r
    got[(n + r) // 2] += f
    mine = funcol.all_to_all_single_autograd(
        local.contiguous(), got, sent, mesh.get_group(i)).movedim(0, -1)
    return DTensor.from_local(mine, mesh, w.placements, run_check=False,
                              shape=w.shape, stride=w.stride())


def split_heads(x: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """x [..., heads * dim] -> [..., heads, dim]. A DTensor whose last
    dim splits over more ranks than divide the heads (8 kv heads on a
    16-way model axis) is gathered along it first, and its gradient
    comes back in the layout it leaves."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        n = math.prod(x.device_mesh.size(i)
                      for i, p in enumerate(x.placements)
                      if p.is_shard() and p.dim == x.ndim - 1)
        if heads % n:
            x = unshard_dim(x, -1)
        return _grad_kept(x.reshape(*x.shape[:-1], heads, dim))
    return x.reshape(*x.shape[:-1], heads, dim)


def vocab_parallel_ce(lg: torch.Tensor, labels: torch.Tensor) -> tuple:
    """(logsumexp, the label's logit) over the last dim of DTensor f32
    logits [..., V] whose vocabulary may be split over mesh dims, without
    gathering it: each rank reduces its slice (the max, then the sum of
    exponentials, then its label's logit where the label falls in the
    slice) and the partials are all-reduced. The max is a constant of
    the gradient, as in ``logsumexp``. Returned as DTensors laid out as
    the logits' rows; the sums run in another order than the plain
    ``logsumexp``. A vocabulary split over mesh dims of one rank is no
    split: the plain ``logsumexp`` runs, as on one card (its backward
    holds one more [rows, V] f32 buffer than the split form's)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, pl = lg.device_mesh, list(lg.placements)
    vdim = lg.ndim - 1
    split = [i for i, p in enumerate(pl)
             if p.is_shard() and p.dim == vdim and mesh.size(i) > 1]
    rows = [Replicate() if p.is_partial() or (p.is_shard() and p.dim == vdim)
            else p for p in pl]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    if not split:
        lg = lg.redistribute(mesh, rows)
        return torch.logsumexp(lg, dim=-1), torch.gather(
            lg, -1, labels.redistribute(mesh, rows)[..., None])[..., 0]
    lab = labels.redistribute(mesh, rows).to_local()
    lg = lg.redistribute(mesh, [p if i in split else rows[i]
                                for i, p in enumerate(pl)])
    x = lg.to_local()
    v_local = x.shape[-1]
    coord = mesh.get_coordinate()
    part = 0
    for i in split:                       # this rank's slice, mesh order
        part = part * mesh.size(i) + coord[i]

    def reduced(t, op):
        return DTensor.from_local(
            t, mesh, [Partial(op) if i in split else rows[i]
                      for i in range(mesh.ndim)],
            run_check=False).redistribute(mesh, rows).to_local()
    m = reduced(x.detach().amax(dim=-1), "max")
    s = reduced(torch.exp(x - m[..., None]).sum(dim=-1), "sum")
    idx = lab - part * v_local
    inside = (idx >= 0) & (idx < v_local)
    ll = torch.gather(x, -1, idx.clamp(0, v_local - 1)[..., None])[..., 0]
    ll = reduced(torch.where(inside, ll, torch.zeros_like(ll)), "sum")
    return (DTensor.from_local(torch.log(s) + m, mesh, rows, run_check=False),
            DTensor.from_local(ll, mesh, rows, run_check=False))


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """x [..., H, D] -> [..., H * D]. A DTensor split along D is gathered
    along it first: merged with whole heads its shards would interleave
    (D split where H cannot be, 6 heads on a 16-way model axis); its
    gradient comes back in the layout it leaves."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if x.shape[-2] > 1:
        x = unshard_dim(x, -1)
    return _grad_kept(x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1]))


def _grad_kept(x: torch.Tensor) -> torch.Tensor:
    """A reshaped DTensor whose gradient must come back in its layout
    for the reshape's backward (``grad_laid_as_forward``)."""
    return grad_laid_as_forward(x) if x.requires_grad else x


def unshard_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dim ``dim`` whole on every rank: a DTensor split along
    it (an argmax over the vocabulary) is gathered along it, its other
    shards kept; anything else is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    pl = [Replicate() if p.is_shard() and p.dim == dim else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl) if pl != list(
        x.placements) else x


def pool_dims(shape: tuple, sizes: dict, first: int) -> list:
    """Spec entries of a paged pool leaf [.., NB, bs, *feat] (NB at
    ``first``) or of the [B, S, *feat] cache rows that fill it (B at
    ``first``): ``first`` over (pod, data) where it divides, the next dim
    (a block's positions, a row's sequence) whole, and "model" on the
    first feature dim it divides (head_dim where the kv heads do not)."""
    dims: list = [None] * len(shape)
    ba = tuple(a for a in ("pod", "data") if a in sizes)
    if ba and shape[first] % _axis_size(sizes, ba) == 0:
        dims[first] = _entry(ba)
    model = sizes.get("model", 1)
    for i in range(first + 2, len(shape)):
        if model > 1 and shape[i] % model == 0:
            dims[i] = "model"
            break
    return dims


def pool_rows(rows: torch.Tensor) -> torch.Tensor:
    """A DTensor's [B, S, *feat] cache rows laid out as
    ``serve_cache_shardings`` lays out the pool [NB, bs, *feat] they fill
    (``pool_dims``: the pool's blocks split as the batch). Anything else
    is returned as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(rows, DTensor):
        return rows
    mesh = rows.device_mesh
    pl = list(placements(tuple(pool_dims(rows.shape, axis_sizes(mesh), 0)),
                         mesh))
    return rows if pl == list(rows.placements) else rows.redistribute(
        mesh, pl)


def index_put_rows(pool: torch.Tensor, idx: tuple,
                   vals: torch.Tensor) -> None:
    """``pool.index_put_(idx, vals)`` for a DTensor pool [nb, bs, *feat]
    written a row per sequence (idx: block and position [B], vals
    [B, *feat]), which DTensor has no in-place rule for: each rank writes
    its rows into its own shard. Where the pool's blocks split over a
    mesh dim the rows split with them (a rank's slots keep their blocks
    in its shard), where a feature dim splits the values split with it,
    and elsewhere every rank writes every row. The block ids are taken as
    they stand on each shard, as ``paged.pool_from_rows`` lays a
    DTensor's pool out (each shard's slots in its own blocks), so tables
    must count from the shard's start.""" 
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = pool.device_mesh
    rows, feat = [], []
    for p in pool.placements:
        if p.is_shard() and p.dim == 0:
            rows.append(Shard(0)), feat.append(Shard(0))
        elif p.is_shard() and p.dim >= 2:
            rows.append(Replicate()), feat.append(Shard(p.dim - 1))
        else:
            rows.append(Replicate()), feat.append(Replicate())

    def local(t, pl):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, pl).to_local()
    pool.to_local().index_put_(tuple(local(i, rows) for i in idx),
                               local(vals, feat))


# ------------------------------------------------------------ inputs -------

def batch_axes(mesh, global_batch: int,
               axes: tuple[str, ...] = ("pod", "data")) -> tuple[str, ...]:
    """Largest prefix of ``axes`` that divides the global batch."""
    sizes = axis_sizes(mesh)
    chosen: list[str] = []
    for a in (a for a in axes if a in sizes):
        if global_batch % _axis_size(sizes, tuple(chosen) + (a,)) == 0:
            chosen.append(a)
    return tuple(chosen)


def data_batch_spec(mesh, global_batch: int, ndim: int,
                    axes: tuple[str, ...] = ("pod", "data")) -> Spec:
    """Spec of a [B, ...] input: batch over ``axes`` when it divides,
    otherwise replicated."""
    ba = batch_axes(mesh, global_batch, axes)
    return (_entry(ba) if ba else None,) + (None,) * (ndim - 1)


def _shape(leaf) -> tuple:
    """The shape of a tensor (meta or not) or of a (shape, dtype) pair."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def _is_leaf(t) -> bool:
    return hasattr(t, "shape") or (
        isinstance(t, tuple) and len(t) == 2 and isinstance(t[0], tuple))


def _map_with_path(fn, tree, path=()):
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    return type(tree)(_map_with_path(fn, v, path + (i,))
                      for i, v in enumerate(tree))


def batch_shardings(batch_struct, mesh, global_batch: int,
                    axes: tuple[str, ...] = ("pod", "data")):
    """``NamedSharding`` of every leaf of a batch (meta tensors or
    (shape, dtype) pairs, ``data.synthetic``'s structs)."""
    return _map_with_path(
        lambda _, s: NamedSharding(mesh, data_batch_spec(
            mesh, global_batch, len(_shape(s)), axes)), batch_struct)


# ------------------------------------------------------------ caches -------

def cache_spec_for(struct, mesh, global_batch: int, *,
                   stacked: int = 1) -> Spec:
    """Spec of one per-slot cache leaf (paged pool leaves and block tables
    take their own branches in ``serve_cache_shardings``). After
    ``stacked`` leading layer-stack dims:
      cross-attn KV [B, Lm, KV, DH] -> batch over (pod, data) if it
                                       divides, else Lm over (pod, data);
                                       heads over model if they divide,
                                       else head_dim;
      SSD state   [B, H, N, P]      -> batch, then H over model;
      conv state  [B, W, C]         -> batch, C over model;
      lengths     [B]               -> batch."""
    shape = _shape(struct)
    sizes = axis_sizes(mesh)
    lead = stacked
    dims: list = [None] * len(shape)
    model = sizes.get("model", 1)
    ba = batch_axes(mesh, global_batch)
    if ba and shape[lead] % _axis_size(sizes, ba) == 0:
        dims[lead] = _entry(ba)
        seq_shardable = False
    else:
        seq_shardable = True
    rest = list(range(lead + 1, len(shape)))
    if rest and seq_shardable and len(shape) >= lead + 2:
        # shard the sequence dim instead (long-context, batch=1 cells)
        s_idx = lead + 1
        sa = tuple(a for a in ("pod", "data") if a in sizes)
        if sa and shape[s_idx] % _axis_size(sizes, sa) == 0:
            dims[s_idx] = _entry(sa)
            rest = [i for i in rest if i != s_idx]
    # "model" to the first remaining dim it divides; for 4-dim KV caches
    # the kv-head dim (lead + 2) first, then head_dim
    order = [lead + 2, lead + 3] if len(shape) - lead == 4 else rest
    for i in order:
        if i < len(shape) and dims[i] is None and model > 1 \
                and shape[i] % model == 0:
            dims[i] = "model"
            break
    return tuple(dims)


def serve_cache_shardings(cfg, cache_struct, mesh, global_batch: int):
    """``NamedSharding`` of every leaf of a model's stacked decode caches
    (``models.api.cache_specs``'s tree of (shape, dtype) pairs).

    The hybrid's mamba states carry two stack dims (n_seg, seg). The
    paged pools [stack, NB, bs, *feat] (``paged.POOL_KEYS``, the
    quantized pools' scales too) never split the within-block position
    axis (``pool_dims``): their block axis goes over (pod, data) when it
    divides, and "model" to the first feature dim it divides. Block
    tables shard over batch alone."""
    from repro_torch.models.paged import POOL_KEYS
    sizes = axis_sizes(mesh)

    def one(path, s):
        shape = _shape(s)
        lead = 2 if cfg.family == "hybrid" and "mamba" in path else 1
        name = path[-1]
        if name in POOL_KEYS:
            return NamedSharding(mesh, tuple(pool_dims(shape, sizes, lead)))
        if name == "block_table":
            dims = [None] * len(shape)
            ba = batch_axes(mesh, global_batch)
            if ba and shape[lead] % _axis_size(sizes, ba) == 0:
                dims[lead] = _entry(ba)
            return NamedSharding(mesh, tuple(dims))
        return NamedSharding(mesh, cache_spec_for(s, mesh, global_batch,
                                                  stacked=lead))
    return _map_with_path(one, cache_struct)
