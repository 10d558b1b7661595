"""Production dry run on a fake process group: trace every (arch × shape
× mesh) cell of the registry and price it on H100 SXM cards (twin of
``repro.launch.dryrun``).

For every cell this driver:

  1. starts a ``"fake"`` default group of 256 (16 × 16) or 512
     (2 × 16 × 16) ranks in this process and builds the production mesh
     on it (``launch.mesh.make_production_mesh``);
  2. lays parameters, optimizer state, batch and caches out as DTensors
     of fake tensors (``FakeTensorMode``: shapes only, no memory) by the
     port's ``param_specs``, ``batch_shardings`` and
     ``serve_cache_shardings``;
  3. runs the port's train, prefill or serve step on them under
     ``activation_sharding`` and ``kernels.traced.card()``: the card's
     path (the fakes are CPU tensors, which autograd's engine can walk
     without a CUDA runtime, and ``card()`` sends them down the card's
     branches), its kernels through their operators' fakes and DTensor
     rules (``kernels.traced``). A missing DTensor rule, a spec that
     does not divide or a shape error fails the cell HERE, with its
     traceback;
  4. counts the step per device (``ecm.step_cost``): flops, bytes,
     collectives per mesh axis and the peak of the live set, and prices
     it with the three roofline terms (``ecm.hopper_roofline``), into
     results/dryrun/<arch>__<shape>__<mesh>.json.

Depth: the step is traced at two or three small depths of the same
widths and extrapolated linearly to the config's (every layer of a
stack costs the same), and serving's flash-attention block walks run
one block for all (``step_cost.trips``); ``cell_cost(...,
extrapolate=False)`` traces the config as it stands. Argument bytes are
counted from the full config's shards, not traced.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-110b --shape train_4k --mesh multi
  python -m repro_torch.launch.dryrun --all --mesh both        # full sweep
  python -m repro_torch.launch.dryrun --list                   # enumerate cells

Nothing here needs a GPU: the fake group and the fake tensors run on
the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from fractions import Fraction

#: layout knobs applied on top of the baseline config via --opts
#: opt1,opt2 (each is a ModelConfig transform)
PERF_OPTS = {
    # the port packs causal attention wherever the reference's knob
    # would (``attention.flash_attention``): nothing to set
    "causal_packing": lambda cfg: cfg,
    "sp_residual": lambda cfg: cfg.with_(sp_residual=True),
    "remat_dots": lambda cfg: cfg.with_(remat_policy="dots"),
    "qchunk_1k": lambda cfg: cfg.with_(q_chunk=1024, kv_chunk=1024),
    "qchunk_2k": lambda cfg: cfg.with_(q_chunk=2048, kv_chunk=2048),
    "cf1": lambda cfg: cfg.with_(
        moe=cfg.moe._replace(capacity_factor=1.0) if cfg.moe else None),
    # handled structurally in _build_cell (sharding plan / optimizer mode):
    "pure_dp": lambda cfg: cfg,
    "mixed": lambda cfg: cfg,   # bf16 params + f32 master (train cells)
}


# ------------------------------------------------------------ the group ----

_MESHES: dict = {}


def production_mesh(multi_pod: bool):
    """The production mesh on a ``"fake"`` default group of 256 or 512
    ranks in this process (rank 0), one per process and shape: a group
    of another size is replaced, and its mesh forgotten."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh
    world = 512 if multi_pod else 256
    if dist.is_initialized() and dist.get_backend() != "fake":
        raise RuntimeError("a non-fake process group exists: the dry run "
                           "needs a process of its own")
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
        _MESHES.clear()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = make_production_mesh(multi_pod=multi_pod,
                                                  device="cpu")
    return _MESHES[multi_pod]


def mesh_groups(mesh) -> dict:
    """{process group name: (axis name, size)} of a mesh's dims."""
    return {mesh.get_group(i).group_name: (name, mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


# ------------------------------------------------------------ fakes --------

def _local_shape(shape, placements, mesh) -> tuple:
    local = list(shape)
    for mesh_dim, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(mesh_dim)
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over {n} ranks ({placements})")
            local[p.dim] //= n
    return tuple(local)


def fake_dtensor(shape, dtype, spec, mesh):
    """A DTensor of ``shape`` laid out by ``spec`` on ``mesh`` whose
    local tensor is an empty fake tensor on the mesh's device (call
    under the fake mode)."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding
    pl = sharding.placements(spec, mesh)
    local = torch.empty(_local_shape(shape, pl, mesh), dtype=dtype,
                        device=mesh.device_type)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def local_bytes(shape, dtype, spec, mesh) -> int:
    """Bytes of one rank's shard of a tensor laid out by ``spec``."""
    import torch

    from repro_torch.distributed import sharding
    pl = sharding.placements(spec, mesh)
    return math.prod(_local_shape(shape, pl, mesh)) * \
        torch.empty((), dtype=dtype).element_size()


def _walk(fn, tree, specs):
    """``fn((shape, dtype), spec)`` over a tree of meta tensors or
    (shape, dtype) pairs and its tree of specs (or NamedShardings)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(fn, tree[k], specs[k]) for k in tree}
    if hasattr(tree, "shape"):
        leaf = (tuple(tree.shape), tree.dtype)
    else:
        leaf = (tuple(tree[0]), tree[1])
    return fn(leaf, getattr(specs, "spec", specs))


# ------------------------------------------------------------ cells --------

def _param_struct(sch, kind: str, mixed: bool) -> dict:
    """The parameter tree's (shape, dtype) pairs as the port holds them:
    f32 to train (bf16 with an f32 master under ``mixed``), the
    ``BF16_WEIGHTS`` leaves bf16 to serve (``init_params(hold_bf16=)``)."""
    import torch

    from repro_torch.models import common
    flat = {}
    for path, spec in common._flatten_schema(sch):
        dtype = spec.dtype
        if kind == "train" and mixed and dtype == torch.float32:
            dtype = torch.bfloat16
        if kind != "train" and common._held_bf16(path.rsplit("/", 1)[-1],
                                                 spec):
            dtype = torch.bfloat16
        flat[path] = (spec.shape, dtype)
    return common._unflatten(flat)


def _build_cell(arch: str, shape_name: str, multi_pod: bool, variant: str,
                opts: tuple = (), cfg=None, *, mesh=None, shape=None):
    """(step, its argument builder, meta, cfg, shape, argument bytes,
    mesh, act rules) for one cell; ``cfg`` overrides the registry's (the
    depth-cut traces), ``mesh`` and ``shape`` (a ``ShapeCell``) the
    production mesh and the named shape."""
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding
    from repro_torch.models import api, paged
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    if cfg is None:
        cfg = config_for(arch, variant, opts)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or production_mesh(multi_pod)
    chips = mesh.size()

    # sharding plan: baseline FSDP(data)×TP(model), or pure-DP for small
    # models (batch over every axis, params replicated)
    pure_dp = "pure_dp" in opts
    param_rules = sharding.PURE_DP_RULES if pure_dp else None
    b_axes = (("pod", "data", "model") if pure_dp else ("pod", "data"))
    act_rules = None
    if pure_dp:
        act_rules = dict(sharding.ACT_RULES_DEFAULT, act_batch=b_axes,
                         act_heads=None, act_mlp=None, act_experts=None,
                         act_res_seq=None)

    sch = api.schema(cfg)
    mixed = "mixed" in opts
    pspec = sharding.param_specs(sch, mesh, param_rules)
    pstruct = _param_struct(sch, shape.kind, mixed)
    parts = [(pstruct, pspec)]          # (struct, spec) trees of arguments

    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(kahan=(variant == "kahan"),
                                    master_weights=mixed)
        f32 = _walk(lambda leaf, s: (leaf[0], torch.float32), pstruct, pspec)
        opt_struct = adamw.AdamWState(
            count=((), torch.int32), m=f32, v=f32,
            carry=f32 if opt_cfg.kahan else None,
            master=f32 if mixed else None)
        opt_spec = adamw.AdamWState(count=(), m=pspec, v=pspec,
                                    carry=pspec, master=pspec)
        batch_struct = synthetic.train_batch_struct(
            cfg, shape.seq_len, shape.global_batch)
        bshard = sharding.batch_shardings(batch_struct, mesh,
                                          shape.global_batch, b_axes)
        parts += [(opt_struct.count, ()), (opt_struct.m, pspec),
                  (opt_struct.v, pspec), (opt_struct.carry, pspec),
                  (opt_struct.master, pspec), (batch_struct, bshard)]
        step = steps.build_train_step(cfg, opt_cfg)

        def make():
            opt = adamw.AdamWState(
                count=fake_dtensor((), torch.int32, (), mesh),
                **{f: _layer_tree(getattr(opt_struct, f),
                                  getattr(opt_spec, f), mesh)
                   for f in ("m", "v", "carry", "master")})
            return (_layer_tree(pstruct, pspec, mesh), opt,
                    _fakes(batch_struct, bshard, mesh), 0)
    elif shape.kind == "prefill":
        batch_struct = synthetic.prefill_batch_struct(
            cfg, shape.seq_len, shape.global_batch)
        bshard = sharding.batch_shardings(batch_struct, mesh,
                                          shape.global_batch, b_axes)
        parts.append((batch_struct, bshard))
        step = steps.build_prefill_step(cfg, cache_size=shape.seq_len)

        def make():
            return (_layer_tree(pstruct, pspec, mesh),
                    _fakes(batch_struct, bshard, mesh))
    else:  # decode: one new token against a seq_len paged cache
        layout = paged.PagedLayout.for_context(shape.seq_len)
        # pad the pool so its block axis divides the (pod, data) degree —
        # serve_cache_shardings then keeps per-device KV at pool/data bytes
        data_degree = math.prod(
            n for a, n in sharding.axis_sizes(mesh).items()
            if a in ("pod", "data"))
        cache_struct = api.cache_specs(
            cfg, shape.global_batch, layout,
            num_blocks=paged.padded_num_blocks(layout, shape.global_batch,
                                               data_degree))
        cshard = sharding.serve_cache_shardings(cfg, cache_struct, mesh,
                                                shape.global_batch)
        tokens_struct = synthetic.decode_tokens_struct(shape.global_batch)
        tshard = sharding.batch_shardings(tokens_struct, mesh,
                                          shape.global_batch, b_axes)
        parts += [(cache_struct, cshard), (tokens_struct, tshard)]
        step = steps.build_serve_step(cfg)

        def make():
            return (_layer_tree(pstruct, pspec, mesh),
                    _fakes(cache_struct, cshard, mesh),
                    _fakes(tokens_struct, tshard, mesh))

    arg_bytes = sum(sum(_leaves(_walk(
        lambda leaf, s: local_bytes(*leaf, s, mesh), t, sp)))
        for t, sp in parts if t is not None)
    meta = dict(arch=arch, shape=shape_name,
                mesh="x".join(map(str, mesh.shape)),
                chips=chips, kind=shape.kind, variant=variant,
                seq_len=shape.seq_len, global_batch=shape.global_batch)
    return step, make, meta, cfg, shape, arg_bytes, mesh, act_rules


def _fakes(struct, specs, mesh):
    return _walk(lambda leaf, s: fake_dtensor(*leaf, s, mesh), struct, specs)


def _layer_tree(struct, specs, mesh):
    """A parameter-shaped tree as the port's steps take it: stacked
    DTensors split into per-layer views (``lm.split_layers``)."""
    from repro_torch.models import lm
    return None if struct is None else lm.split_layers(
        _fakes(struct, specs, mesh))


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def config_for(arch: str, variant: str = "kahan", opts: tuple = ()):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if variant == "naive":
        cfg = cfg.with_(kahan_attn=False, kahan_ssm_state=False)
    elif variant == "kahan":
        cfg = cfg.with_(kahan_ssm_state=cfg.family in ("ssm", "hybrid"))
    for opt in opts:
        cfg = PERF_OPTS[opt](cfg)
    return cfg


# ------------------------------------------------------------ depth --------

def depth_units(cfg) -> tuple:
    """How many of each repeated unit the config stacks: (1, units...),
    the cost being linear in them."""
    if cfg.family == "hybrid":
        seg = cfg.hybrid.segment_len
        return (1, cfg.num_layers, cfg.num_layers // seg)
    if cfg.family == "audio":
        return (1, cfg.encdec.enc_layers, cfg.num_layers)
    if cfg.first_k_dense:
        return (1, cfg.first_k_dense, cfg.num_layers - cfg.first_k_dense)
    return (1, cfg.num_layers)


def depth_cuts(cfg) -> list:
    """Configs of the same widths at small depths whose ``depth_units``
    span the config's: two for one stack, three for two. Each cut holds
    every kind of layer, so the peak (a layer's transient set over the
    saved ones) extrapolates too: a cut without a MoE layer would
    price that layer's transient as if it were kept."""
    if cfg.family == "hybrid":
        h = cfg.hybrid
        return [cfg.with_(num_layers=1, hybrid=h._replace(segment_len=1)),
                cfg.with_(num_layers=2, hybrid=h._replace(segment_len=1)),
                cfg.with_(num_layers=3, hybrid=h._replace(segment_len=2))]
    if cfg.family == "audio":
        e = cfg.encdec
        return [cfg.with_(num_layers=1, encdec=e._replace(enc_layers=1)),
                cfg.with_(num_layers=1, encdec=e._replace(enc_layers=2)),
                cfg.with_(num_layers=2, encdec=e._replace(enc_layers=1))]
    if cfg.first_k_dense:
        return [cfg.with_(first_k_dense=1, num_layers=2),
                cfg.with_(first_k_dense=1, num_layers=3),
                cfg.with_(first_k_dense=2, num_layers=3)]
    return [cfg.with_(num_layers=1), cfg.with_(num_layers=2)]


def _solve(rows: list, target: tuple) -> list:
    """Coefficients c with sum_i c_i rows[i] == target, exactly
    (Gauss-Jordan over fractions)."""
    n = len(rows)
    # solve A^T c = target, A's rows the cuts' units
    a = [[Fraction(rows[j][i]) for j in range(n)] + [Fraction(target[i])]
         for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] != 0)
        a[col], a[piv] = a[piv], a[col]
        p = a[col][col]
        a[col] = [x / p for x in a[col]]
        for r in range(n):
            if r != col and a[r][col] != 0:
                f = a[r][col]
                a[r] = [x - f * y for x, y in zip(a[r], a[col])]
    return [a[i][n] for i in range(n)]


@contextlib.contextmanager
def _card_collectives():
    """DTensor's shard-to-shard moves as the all-to-all they are on the
    card: on a CPU mesh DTensor would gather and chunk instead (gloo has
    no all-to-all), which moves n times the bytes. Every DTensor module
    holding ``shard_dim_alltoall`` gets the card's form while the step
    is traced."""
    import sys

    import torch
    try:
        from torch.distributed._functional_collectives import (
            _group_or_group_name, _resolve_group)
        from torch.distributed.tensor import _collective_utils
        orig = _collective_utils.shard_dim_alltoall
    except (ImportError, AttributeError):
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = _resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, _group_or_group_name(group))
    holders = [m for name, m in list(sys.modules.items())
               if name.startswith("torch.distributed.tensor") and m is not None
               and getattr(m, "shard_dim_alltoall", None) is orig]
    for m in holders:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m in holders:
            m.shard_dim_alltoall = orig


def trace_step(step, make, mesh, act_rules, *, extrapolate: bool,
               record: bool = False):
    """One traced run of ``step(*make())``: its ``StepCost`` (with the
    storages live at its peak under ``record``)."""
    import logging
    # DTensor warns of every two-axis gather it makes; the counts say it
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import sharding
    from repro_torch.ecm import step_cost
    import torch.backends.opt_einsum as opt_einsum

    from repro_torch.kernels import traced
    # opt_einsum plans every einsum's contraction order in Python (~18
    # ms a call here); a two-operand einsum has one order
    with traced.card(), _card_collectives(), \
            opt_einsum.flags(enabled=False), \
            FakeTensorMode(allow_non_fake_inputs=True):
        args = make()
        with sharding.activation_sharding(mesh, act_rules), \
                step_cost.StepCounter(mesh_groups(mesh),
                                      extrapolate=extrapolate,
                                      record=record) as counter:
            out = step(*args)
            counter.finish()
            del out, args
    return counter.cost


def cell_cost(arch, shape_name, multi_pod, variant="kahan", opts=(), *,
              extrapolate: bool = True, cfg=None, mesh=None, shape=None):
    """(StepCost of the full-depth step, the cell's build). Extrapolated
    from the depth cuts unless ``extrapolate`` is False."""
    from repro_torch.ecm.step_cost import StepCost
    kw = dict(mesh=mesh, shape=shape)
    full = _build_cell(arch, shape_name, multi_pod, variant, opts, cfg=cfg,
                       **kw)
    step, make, _, cfg, _, _, mesh, act_rules = full
    if not extrapolate:
        return trace_step(step, make, mesh, act_rules,
                          extrapolate=False), full
    cuts = depth_cuts(cfg)
    costs = []
    for c in cuts:
        s, mk, _, _, _, _, m, r = _build_cell(arch, shape_name, multi_pod,
                                              variant, opts, cfg=c, **kw)
        costs.append(trace_step(s, mk, m, r, extrapolate=True))
    coef = _solve([depth_units(c) for c in cuts], depth_units(cfg))
    # flops, bytes and collectives linearly; the peak by its phases'
    # stacked sets and transients (``StepCost.extrapolate_peak``)
    return StepCost.combine(zip([float(c) for c in coef], costs)), full


def model_flops(cfg, shape) -> float:
    """Assignment formula: 6·N·D train (2·N·D forward-only serve), with
    N = active params excluding embedding gathers (MoE: top_k of E)."""
    from repro_torch.models import api, common

    sch = api.schema(cfg)
    total = 0.0
    for path, spec in common._flatten_schema(sch):
        n = math.prod(spec.shape)
        leaf = path.split("/")[-1]
        if leaf in ("embed", "pos_embed") and not (
                cfg.tie_embeddings or cfg.family == "audio"):
            continue  # gather-only use
        if cfg.moe is not None and "/ffn/" in path and leaf in (
                "w_gate_up", "w_down") and spec.shape[0] == cfg.moe.num_experts:
            n *= cfg.moe.top_k / cfg.moe.num_experts
        total += n
    if shape.kind == "train":
        return 6.0 * total * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * total * shape.seq_len * shape.global_batch
    return 2.0 * total * shape.global_batch   # decode: one token per seq


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             variant: str = "kahan", opts: tuple = ()) -> dict:
    from repro_torch.ecm import hopper_roofline
    from repro_torch.ecm.machines import H100_SXM
    from repro_torch.distributed import sharding

    t0 = time.time()
    cost, full = cell_cost(arch, shape_name, multi_pod, variant, opts)
    t_trace = time.time() - t0
    _, _, meta, cfg, shape, arg_bytes, mesh, _ = full
    peak = cost.peak_bytes
    mem = {"argument_size_in_bytes": int(arg_bytes),
           "temp_size_in_bytes": int(peak),
           "hbm_bytes": H100_SXM["hbm_bytes"],
           "fits": bool(arg_bytes + peak <= H100_SXM["hbm_bytes"])}
    report = hopper_roofline.roofline_from_cost(
        arch=arch, shape=shape_name, mesh=meta["mesh"], chips=meta["chips"],
        cost=cost, model_flops=model_flops(cfg, shape),
        bytes_per_chip=float(arg_bytes + peak),
        mesh_shape=sharding.axis_sizes(mesh))

    result = dict(
        meta,
        opts=list(opts),
        trace_s=round(t_trace, 1),
        flops=cost.flops, bytes=cost.bytes_accessed,
        dot_flops=cost.dot_flops, elementwise_flops=cost.elementwise_flops,
        kernel_calls=cost.kernel_calls,
        cost_warnings=cost.warnings[:20],
        memory_analysis=mem,
        collectives=report.collectives,
        collective_bytes_by_axis=cost.axis_bytes,
        collective_bytes_weighted=report.collective_bytes,
        t_compute_s=report.t_compute_s, t_memory_s=report.t_memory_s,
        t_collective_s=report.t_collective_s, dominant=report.dominant,
        model_flops=report.model_flops,
        useful_flop_ratio=report.useful_flop_ratio,
        roofline_fraction=report.roofline_fraction,
        rates=f"{H100_SXM['name']} data sheet, 700 W",
        status="ok",
    )
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{meta['mesh']}"
        if variant != "kahan":
            fname += f"__{variant}"
        if opts:
            fname += "__" + "+".join(opts)
        with open(os.path.join(out_dir, fname + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def enumerate_cells():
    from repro_torch.configs import REGISTRY, get_config, shapes_for
    cells = []
    for arch in sorted(REGISTRY):
        for shape_name in shapes_for(get_config(arch)):
            cells.append((arch, shape_name))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--variant", choices=["kahan", "naive"], default="kahan")
    ap.add_argument("--opts", default="",
                    help="comma-separated layout knobs: "
                         + ",".join(PERF_OPTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opts.split(",") if o)

    if args.list:
        for arch, shape in enumerate_cells():
            print(f"{arch:28s} {shape}")
        return

    cells = (enumerate_cells() if args.all
             else [(args.arch, args.shape)])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch, shape in cells:
        for multi_pod in meshes:
            label = f"{arch} × {shape} × {'2x16x16' if multi_pod else '16x16'}"
            try:
                r = run_cell(arch, shape, multi_pod, args.out, args.variant,
                             opts)
                m = r["memory_analysis"]
                print(f"OK   {label}: trace={r['trace_s']}s "
                      f"flops/chip={r['flops']:.3e} "
                      f"args={m['argument_size_in_bytes'] / 1e9:.2f}GB "
                      f"peak={m['temp_size_in_bytes'] / 1e9:.2f}GB "
                      f"fits={m['fits']} "
                      f"dominant={r['dominant']} "
                      f"roofline={r['roofline_fraction']:.3f}", flush=True)
            except Exception:
                failures += 1
                print(f"FAIL {label}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
