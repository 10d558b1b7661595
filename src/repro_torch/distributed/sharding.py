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
    # the reference's sequence-parallel residual (its cfg.sp_residual,
    # a dry-run knob with no field in the port)
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


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict | None = None):
    """Within this context ``shard_act`` lays DTensor activations out on
    ``mesh`` (a ``DeviceMesh``) by ``rules``, and a plain tensor that
    meets a DTensor in an op (a RoPE table, a mask) counts as replicated
    on its mesh, as a constant does under the reference's jit."""
    from torch.distributed.tensor.experimental import implicit_replication
    token = _ACT_CTX.set((mesh, rules or ACT_RULES_DEFAULT))
    try:
        with implicit_replication():
            yield
    finally:
        _ACT_CTX.reset(token)


def shard_act(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Lay an activation out by its logical dim names: ``x`` itself
    unless an ``activation_sharding`` context is active and ``x`` is a
    DTensor, which is then redistributed to the names' spec."""
    ctx = _ACT_CTX.get()
    if ctx is None or len(names) != x.ndim:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = spec_for_axes(tuple(names), mesh, tuple(x.shape), rules)
    return x.redistribute(mesh, placements(spec, mesh))


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its pending partial sums reduced: a DTensor that a
    product over a sharded dim left ``Partial`` comes back replicated on
    those mesh dims, in its own dtype (f32 after a product), so nothing
    rounds the partials before they are summed. Anything else is
    returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


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
    axis: their block axis goes over (pod, data) when it divides, and
    "model" to the first feature dim it divides. Block tables shard over
    batch alone."""
    from repro_torch.models.paged import POOL_KEYS
    sizes = axis_sizes(mesh)

    def one(path, s):
        shape = _shape(s)
        lead = 2 if cfg.family == "hybrid" and "mamba" in path else 1
        name = path[-1]
        if name in POOL_KEYS:
            dims: list = [None] * len(shape)
            ba = tuple(a for a in ("pod", "data") if a in sizes)
            if ba and shape[lead] % _axis_size(sizes, ba) == 0:
                dims[lead] = _entry(ba)
            model = sizes.get("model", 1)
            for i in range(lead + 2, len(shape)):
                if model > 1 and shape[i] % model == 0:
                    dims[i] = "model"
                    break
            return NamedSharding(mesh, tuple(dims))
        if name == "block_table":
            dims = [None] * len(shape)
            ba = batch_axes(mesh, global_batch)
            if ba and shape[lead] % _axis_size(sizes, ba) == 0:
                dims[lead] = _entry(ba)
            return NamedSharding(mesh, tuple(dims))
        return NamedSharding(mesh, cache_spec_for(s, mesh, global_batch,
                                                  stacked=lead))
    return _map_with_path(one, cache_struct)
