"""The port's distributed layer (``repro_torch.distributed``,
``launch.mesh``, the elastic ``CheckpointManager.restore``) against the
reference's, on the cases of ``tests/test_distributed.py`` but the dry
run: the two pods' compensated all-reduce, the ring of eight, the EF
int8 all-reduce, the GPipe pipeline and the elastic re-mesh.

One JAX subprocess with 8 forced host devices (run as the reference's
own tests run it) writes the reference's outputs; one world of 8 torch
ranks on gloo over 127.0.0.1, one subprocess and one intra-op thread per
rank, runs the port on the same inputs (made here from numpy seeds) and
writes each rank's outputs. The two run side by side.

Tolerances, and why:
  * the two pods, the rings (compensated and naive): bitwise. Their
    arithmetic is adds and subtractions in the reference's order, which
    both stacks round alike.
  * EF int8 over 30 steps: within 16 eps max|g| of the reference at
    every step, on the outputs and on the residual. The port runs the
    reference's quantizer op for op (``quant.core.quantize_blocks`` is
    bitwise the reference's eager one), but XLA's jit on the CPU
    contracts ``x - q * scale`` (the residual) and ``acc + q * scale``
    into fused multiply-adds, one rounding fewer, so the jitted
    reference parts from the port by a few ulps, which the error
    feedback carries on. The limit lies far below one quantization step
    (max|g| / 127), so it also holds every int8 code to the
    reference's.
  * the pipeline: forward and gradient within 1e-5 (atol and rtol) of
    the reference. Each stage is a [2, 16] x [16, 16] product and a
    tanh, which XLA and torch compute in their own ways.
  * the re-mesh: each rank's local shard bitwise the matching slice of
    what was saved.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
EF_STEPS = 30
TIMEOUT = 300
# (arch, dense_ffn) of the layers run under activation_sharding: GQA
# attention, MLA attention with deepseek-v2's dense MLP, the Mamba2 mixer
BLOCKS = (("qwen1.5-0.5b", False), ("deepseek-v2-236b", True),
          ("mamba2-780m", False))
# (name, arch, ModelConfig knobs) of the layers run the same way with the
# dry run's sites: MoE's expert site (olmoe: GQA + MoE), the
# sequence-sharded residual
KNOB_BLOCKS = (("olmoe-1b-7b", "olmoe-1b-7b", {}),
               ("qwen1.5-0.5b+sp_residual", "qwen1.5-0.5b",
                {"sp_residual": True}))
# (name, ModelConfig knobs) of the reduced qwen1.5 layers run forward and
# backward on 8 ranks: the SwiGLU MLP's gate/up kept split over the model
# axis (each rank its own gate and up columns), and the same under the
# sequence-sharded residual
GRAD_BLOCKS = (("qwen1.5-0.5b", {}),
               ("qwen1.5-0.5b+sp_residual", {"sp_residual": True}))
# (name, capacity_factor, mesh) of the MoE layers run forward and
# backward on 8 ranks: reduced olmoe's own (1.25), and 0.25, at which the
# 128 tokens x 2 of 8 experts overflow every expert's capacity of 8 and
# tokens of different batch shards compete for it, on (data 4, model 2);
# and reduced olmoe's own on (pod 2, data 2, model 2), the batch over pod
# and data and the experts' d over data alone (2x16x16's placements)
MOE_CASES = (("olmoe", None, "data"), ("contested", 0.25, "data"),
             ("pod", None, "pod"))
# the MoE layer's gradients against the single process's: relative
# norm, as the card's product backward is held (chip_smoke's
# DENSE_BWD_RTOL); y and the aux losses too
MOE_RTOL = 1e-3

REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.distributed import collectives, compression
from repro.distributed.pipeline import make_pipeline_fn

inp = dict(np.load(sys.argv[1]))
out = {}

def per_device(fn, mesh, axis, *xs):
    spec = P(axis, None)
    g = shard_map(lambda *v: tuple(r[None] for r in fn(*(a[0] for a in v))),
                  mesh=mesh, in_specs=(spec,) * len(xs),
                  out_specs=(spec,) * len(xs) if len(xs) > 1 else (spec,))
    return [np.asarray(r) for r in jax.jit(g)(*map(jnp.asarray, xs))]

mesh = jax.make_mesh((2, 4), ("pod", "data"))
x = np.stack([inp["pods_a"], inp["pods_b"]])
out["pods_kahan"], = per_device(
    lambda v: (collectives.kahan_all_reduce(v, "pod"),), mesh, "pod", x)
out["pods_psum"], = per_device(
    lambda v: (jax.lax.psum(v, "pod"),), mesh, "pod", x)

mesh = jax.make_mesh((8,), ("pod",))
out["ring_kahan"], = per_device(
    lambda v: (collectives.kahan_all_reduce(v, "pod"),), mesh, "pod",
    inp["ring_x"])
out["ring_naive"], = per_device(
    lambda v: (collectives.naive_ring_all_reduce(v, "pod"),), mesh, "pod",
    inp["ring_x"])

mesh = jax.make_mesh((4, 2), ("pod", "x"))
def ef(v, r):
    o, st = compression.ef_quantized_all_reduce(
        v, compression.EFState(r), "pod")
    return o, st.residual
g = inp["ef_g"]
resid = np.zeros_like(g)
outs = []
for _ in range(%(ef_steps)d):
    o, resid = per_device(ef, mesh, "pod", g, resid)
    outs.append(o)
out["ef_outs"] = np.stack(outs)
out["ef_resid"] = resid

mesh = jax.make_mesh((4, 2), ("stage", "other"))
pipe = make_pipeline_fn(lambda p, h: jnp.tanh(h @ p["w"]), mesh, "stage")
ws, xm = jnp.asarray(inp["pipe_ws"]), jnp.asarray(inp["pipe_x"])
out["pipe_out"] = np.asarray(jax.jit(lambda w, v: pipe({"w": w}, v))(ws, xm))
out["pipe_grad"] = np.asarray(jax.jit(jax.grad(
    lambda w: jnp.sum(pipe({"w": w}, xm) ** 2)))(ws))
np.savez(sys.argv[2], **out)
""" % {"ef_steps": EF_STEPS}

WORKER = """
import os, sys
BLOCKS = [(a, a, d, {}) for a, d in %(blocks)r] + [
    (n, a, False, k) for n, a, k in %(knob_blocks)r]
MOE_CASES = %(moe_cases)r
GRAD_BLOCKS = %(grad_blocks)r
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["INIT"],
                        world_size=world, rank=rank)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import collectives, compression, sharding
from repro_torch.distributed.pipeline import make_pipeline_fn
from repro_torch.kernels import invariant_gemm
from repro_torch.launch import mesh as lmesh

inp = dict(np.load(sys.argv[1]))
out = {}
t = torch.from_numpy

# the two pods: ranks 0 and 1
pods = dist.new_group([0, 1])
if rank < 2:
    x = t(inp["pods_a"] if rank == 0 else inp["pods_b"])
    out["pods_kahan"] = collectives.kahan_all_reduce(x, pods).numpy()
    out["pods_naive"] = collectives.naive_ring_all_reduce(x, pods).numpy()

# the ring of eight: the whole world
x = t(inp["ring_x"][rank])
out["ring_kahan"] = collectives.kahan_all_reduce(x).numpy()
out["ring_naive"] = collectives.naive_ring_all_reduce(x).numpy()

# EF int8 over the pods' axis of a (4, 2) mesh
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("pod", "x"))
pod = mesh.get_local_rank("pod")
g = t(inp["ef_g"][pod])
state = compression.ef_init(g)
outs = []
for _ in range(int(sys.argv[3])):
    o, state = compression.ef_quantized_all_reduce(
        g, state, mesh.get_group("pod"))
    outs.append(o.numpy())
out["ef_pod"] = np.asarray(pod)
out["ef_outs"] = np.stack(outs)
out["ef_resid"] = state.residual.numpy()
# the tree reducer over the pods' axis
tree = {"a": g, "b": [2 * g]}
red = collectives.make_all_reduce_fn(mesh, "pod")(tree)
out["tree_a"], out["tree_b"] = red["a"].numpy(), red["b"][0].numpy()

# GPipe over the stages of a (4, 2) mesh
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("stage", "other"))
pipe = make_pipeline_fn(lambda p, h: torch.tanh(h @ p["w"]), mesh, "stage")
ws = t(inp["pipe_ws"]).clone().requires_grad_(True)
y = pipe({"w": ws}, t(inp["pipe_x"]))
(y ** 2).sum().backward()
stage = mesh.get_local_rank("stage")
out["pipe_out"] = y.detach().numpy()
out["pipe_stage"] = np.asarray(stage)
out["pipe_grad"] = ws.grad[stage].numpy()
out["pipe_grad_others"] = np.asarray(float(
    ws.grad.abs().sum() - ws.grad[stage].abs().sum()))

# the production axes on 8 ranks
m = lmesh.make_test_mesh(device="cpu")
out["test_mesh"] = np.asarray(list(m.shape))
out["test_mesh_names"] = np.asarray(list(m.mesh_dim_names))
m = lmesh.make_test_mesh(multi_pod=True, device="cpu")
out["test_mesh_pod"] = np.asarray(list(m.shape))

# the elastic re-mesh: save under (2, 2, 2), restore under (4, 2)
mesh_a = init_device_mesh("cpu", (2, 2, 2),
                          mesh_dim_names=("pod", "data", "model"))
mesh_b = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
full_w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
full_b = torch.ones(8)
tree = {"w": distribute_tensor(full_w, mesh_a, sharding.placements(
            ("data", "model"), mesh_a)),
        "b": distribute_tensor(full_b, mesh_a, sharding.placements(
            ("model",), mesh_a)),
        "step": torch.tensor(7)}
d = sys.argv[4]
mgr = CheckpointManager(d)            # async by default, no barrier here
mgr.save(7, tree, extra={"mesh": [2, 2, 2]})
out["latest"] = np.asarray(mgr.latest_step())
target = {"w": full_w, "b": full_b, "step": torch.tensor(0)}
shard_b = {"w": sharding.NamedSharding(mesh_b, ("data", "model")),
           "b": sharding.NamedSharding(mesh_b, ("model",)),
           "step": sharding.NamedSharding(mesh_b, ())}
r = mgr.restore(7, target, shard_b)
coord = mesh_b.get_coordinate()
out["coord_b"] = np.asarray(coord)
out["w_local"] = r["w"].to_local().numpy()
out["b_local"] = r["b"].to_local().numpy()
out["w_full"] = r["w"].full_tensor().numpy()
out["step_local"] = r["step"].to_local().numpy()
out["w_mesh"] = np.asarray(list(r["w"].device_mesh.shape))
plain = mgr.restore(7, target)
out["b_plain"] = plain["b"].numpy()
out["plain_is_dtensor"] = np.asarray(hasattr(plain["w"], "to_local"))
# a second save, read back on every rank as soon as save returns
tree["b"] = distribute_tensor(2 * full_b, mesh_a, sharding.placements(
    ("model",), mesh_a))
mgr.save(8, tree)
out["latest_8"] = np.asarray(mgr.latest_step())
out["b_8"] = mgr.restore(8, target, shard_b)["b"].full_tensor().numpy()

# shard_act inside a mesh context: a replicated DTensor is laid out
act = distribute_tensor(torch.randn(8, 4, 4, 2, generator=torch.Generator(
    ).manual_seed(0)), mesh_b, [Replicate(), Replicate()])
with sharding.activation_sharding(mesh_b):
    laid = sharding.shard_act(act, "act_batch", "act_seq", "act_heads", None)
out["act_placements"] = np.asarray([str(p) for p in laid.placements])
out["act_same"] = np.asarray(torch.equal(laid.full_tensor(),
                                         act.full_tensor()))
# one reduced layer's training forward with its parameters laid out by
# param_specs on the (4, 2) mesh and h batch-sharded, inside
# activation_sharding, against the plain forward of the same tensors
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config, reduced
from repro_torch.models import blocks, common

from repro_torch.models import moe
ROUTES = []                    # every routing moe_forward makes
route = moe._route
def recording(*a, **k):
    r = route(*a, **k)
    ROUTES.append(r)
    return r
moe._route = recording

def unsorted(r):
    # (slot, keep) of each (token, k) pair in token order
    slot, keep = torch.empty_like(r.slot), torch.empty_like(r.keep)
    slot[r.order], keep[r.order] = r.slot, r.keep
    return slot, keep

def same_routing(whole, part, shard):
    # the routing of batch shard `shard` (its T_loc tokens) against the
    # single process's routing of every token: top-k experts, slots,
    # keeps and the global counts, bitwise
    n, k = part.top_e.shape
    rows, pairs = slice(shard * n, (shard + 1) * n), \
        slice(shard * n * k, (shard + 1) * n * k)
    (s0, k0), (s1, k1) = unsorted(whole), unsorted(part)
    return [torch.equal(whole.top_e[rows], part.top_e),
            torch.equal(s0[pairs], s1), torch.equal(k0[pairs], k1),
            torch.equal(whole.counts, part.counts)]

def near_tie(r, probs):
    # the smallest gap of the router's top-k against the next expert and
    # between its own ranks, exact ties (equal bf16 logits, which both
    # sides break to the lower expert) aside: routing pinned away from
    # near-ties
    top = torch.sort(probs, dim=-1, descending=True).values
    k = r.top_e.shape[1]
    gaps = top[:, :k] - top[:, 1:k + 1]
    return float(gaps[gaps > 0].min())

seen = []
lay_out = sharding.shard_act
def counting(x, *names):
    y = lay_out(x, *names)
    if isinstance(x, DTensor):
        seen.append([str(p) for p in y.placements])
    return y
sharding.shard_act = counting
for name, arch, dense, knobs in BLOCKS:
    cfg = reduced(get_config(arch)).with_(**knobs)
    schema = (blocks.dense_block_schema(cfg, cfg.dense_d_ff) if dense
              else blocks.block_schema(cfg))
    p = common.init_params(schema, torch.Generator().manual_seed(0),
                           torch.device("cpu"), hold_bf16=False)
    specs = sharding.param_specs(schema, mesh_b)
    def lay(t, s):
        if isinstance(t, dict):
            return {k: lay(t[k], s[k]) for k in t}
        return distribute_tensor(t, mesh_b, sharding.placements(s, mesh_b))
    h = torch.randn(4, 32, cfg.d_model, generator=torch.Generator(
        ).manual_seed(1)).to(torch.bfloat16)
    ROUTES.clear()
    want, _ = blocks.block_apply(p, h, cfg, dense_ffn=dense)
    seen.clear()
    with sharding.activation_sharding(mesh_b):
        got, _ = blocks.block_apply(
            lay(p, specs), distribute_tensor(h, mesh_b, sharding.placements(
                ("data", None, None), mesh_b)), cfg, dense_ffn=dense)
    if ROUTES:
        whole, part = ROUTES
        out[f"block_{name}_routing"] = np.asarray(same_routing(
            whole, part, mesh_b.get_local_rank("data")))
        out[f"block_{name}_route_rows"] = np.asarray(
            [part.top_e.shape[0], part.st.shape[0]])
    out[f"block_{name}_want"] = want.float().numpy()
    out[f"block_{name}_got"] = got.full_tensor().float().numpy()
    out[f"block_{name}_seen"] = np.asarray(seen, dtype=str).reshape(-1, 2)
sharding.shard_act = lay_out

# reduced qwen1.5 layers forward and backward: every gradient leaf and h's
# against the plain layer's on the same tensors
def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + "/" + k)
    else:
        yield path, tree

for name, knobs in GRAD_BLOCKS:
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(**knobs)
    schema = blocks.block_schema(cfg)
    p = common.init_params(schema, torch.Generator().manual_seed(0),
                           torch.device("cpu"), hold_bf16=False)
    specs = dict(leaves(sharding.param_specs(schema, mesh_b)))
    h = torch.randn(4, 32, cfg.d_model, generator=torch.Generator(
        ).manual_seed(1)).to(torch.bfloat16)
    dy = torch.randn(4, 32, cfg.d_model, generator=torch.Generator(
        ).manual_seed(2))
    def grads(tree, hh, dyy):
        flat = dict(leaves(tree))
        req = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        nested = {}
        for k, v in req.items():
            node = nested
            *head, last = k.strip("/").split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = v
        hh = hh.detach().requires_grad_(True)
        y, _ = blocks.block_apply(nested, hh, cfg)
        return y, torch.autograd.grad((y.float() * dyy).sum(),
                                      list(req.values()) + [hh])
    y0, g0 = grads(p, h, dy)
    rows = sharding.placements(("data", None, None), mesh_b)
    laid = {k: distribute_tensor(v, mesh_b, sharding.placements(specs[k],
                                                                mesh_b))
            for k, v in leaves(p)}
    # what each SwiGLU call holds of the hidden dim on this rank, and the
    # layout of the rows each product takes
    widths, taken = [], []
    swiglu, product = common.swiglu, invariant_gemm.product
    def held(gate, up):
        widths.append((gate.to_local() if isinstance(gate, DTensor)
                       else gate).shape[-1])
        return swiglu(gate, up)
    def spied(x, w, **kw):
        if isinstance(x, DTensor):
            taken.append([str(q) for q in x.placements])
        return product(x, w, **kw)
    common.swiglu, invariant_gemm.product = held, spied
    with sharding.activation_sharding(mesh_b):
        y1, g1 = grads(laid, distribute_tensor(h, mesh_b, rows),
                       distribute_tensor(dy, mesh_b, rows))
    common.swiglu, invariant_gemm.product = swiglu, product
    out[f"grad_{name}_widths"] = np.asarray(widths + [cfg.d_ff])
    out[f"grad_{name}_taken"] = np.asarray(taken, dtype=str)
    out[f"grad_{name}_y"] = np.stack([
        y0.detach().float().numpy(),
        y1.full_tensor().detach().float().numpy()])
    names = [k for k, _ in leaves(p)] + ["h"]
    out[f"grad_{name}_names"] = np.asarray(names)
    for key, a, b in zip(names, g0, g1):
        out[f"grad_{name}_{key}"] = np.stack(
            [a.float().numpy(), b.full_tensor().float().numpy()])

# the MoE layer alone, forward and backward, on the (4, 2) mesh: the
# reduced olmoe layer, and the same with capacity_factor 0.25, where
# tokens of different batch shards compete for an expert's capacity
def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())
for name, cf, where in MOE_CASES:
    mesh_m = mesh_a if where == "pod" else mesh_b
    batch_axes = ("pod", "data") if where == "pod" else "data"
    shard = (mesh_m.get_local_rank("pod") * 2 if where == "pod" else 0) \
        + mesh_m.get_local_rank("data")
    mcfg = reduced(get_config("olmoe-1b-7b")).moe
    mcfg = mcfg._replace(capacity_factor=cf or mcfg.capacity_factor)
    d = reduced(get_config("olmoe-1b-7b")).d_model
    schema = moe.moe_schema(d, mcfg)
    p = common.init_params(schema, torch.Generator().manual_seed(0),
                           torch.device("cpu"), hold_bf16=False)
    x = torch.randn(8, 16, d, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    dy = torch.randn(8, 16, d, generator=torch.Generator().manual_seed(2))
    def run(params, xx, dyy):
        leaves = {key: v.detach().requires_grad_(True)
                  for key, v in params.items()}
        xx = xx.detach().requires_grad_(True)
        y, aux = moe.moe_forward(leaves, xx, mcfg)
        loss = (y.float() * dyy).sum() + sum(aux.values())
        return y, aux, torch.autograd.grad(loss, list(leaves.values())
                                           + [xx])
    ROUTES.clear()
    y0, a0, g0 = run(p, x, dy)
    summed = []
    rounded = invariant_gemm._rounded_grad
    def counted(g, like):
        summed.append(type(g) is not torch.Tensor)
        return rounded(g, like)
    invariant_gemm._rounded_grad = counted
    specs = sharding.param_specs(schema, mesh_m)
    rows = sharding.placements((batch_axes, None, None), mesh_m)
    with sharding.activation_sharding(mesh_m):
        y1, a1, g1 = run({key: distribute_tensor(v, mesh_m,
                                                 sharding.placements(
                                                     specs[key], mesh_m))
                          for key, v in p.items()},
                         distribute_tensor(x, mesh_m, rows),
                         distribute_tensor(dy, mesh_m, rows))
    invariant_gemm._rounded_grad = rounded
    out[f"moe_{name}_summed"] = np.asarray(sum(summed))
    whole, part = ROUTES
    probs = torch.softmax(common.dense(x.reshape(-1, d), p["router"]
                                       ).float(), dim=-1)
    out[f"moe_{name}_gap"] = np.asarray(near_tie(whole, probs))
    out[f"moe_{name}_routing"] = np.asarray(same_routing(
        whole, part, shard))
    out[f"moe_{name}_rows"] = np.asarray([t.shape[0] for t in part])
    out[f"moe_{name}_drop"] = np.asarray(
        [float(a0["moe_drop_fraction"]),
         float(a1["moe_drop_fraction"].full_tensor())])
    out[f"moe_{name}_y"] = np.asarray(rel(y1.full_tensor(), y0))
    out[f"moe_{name}_aux"] = np.asarray(
        [rel(a1[key].full_tensor(), a0[key]) for key in a0])
    out[f"moe_{name}_grads"] = np.asarray(
        [rel(b.full_tensor(), a) for a, b in zip(g0, g1)])
np.savez(os.path.join(sys.argv[2], f"rank{rank}.npz"), **out)
dist.destroy_process_group()
""" % {"blocks": BLOCKS, "knob_blocks": KNOB_BLOCKS, "moe_cases": MOE_CASES,
       "grad_blocks": GRAD_BLOCKS}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4096) * 1e6).astype(np.float32)
    b = (-a + rng.standard_normal(4096) * 1e-2).astype(np.float32)
    rng = np.random.default_rng(1)
    ring = (rng.standard_normal((8, 1000))
            * 10.0 ** rng.integers(-4, 5, (8, 1000))).astype(np.float32)
    g = np.random.default_rng(2).standard_normal((4, 512)).astype(np.float32)
    rng = np.random.default_rng(3)
    ws = rng.standard_normal((4, 16, 16)).astype(np.float32) * 0.3
    x = rng.standard_normal((6, 2, 16)).astype(np.float32)
    return dict(pods_a=a, pods_b=b, ring_x=ring, ef_g=g, pipe_ws=ws,
                pipe_x=x)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    inp = dict(_inputs())
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    (tmp / "ref.py").write_text(textwrap.dedent(REFERENCE))
    (tmp / "worker.py").write_text(textwrap.dedent(WORKER))
    (tmp / "ckpt").mkdir()
    ref = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp / "inputs.npz"),
         str(tmp / "ref.npz")], env=ref_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    init = f"tcp://127.0.0.1:{_free_port()}"
    ranks = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(tmp / "inputs.npz"),
         str(tmp), str(EF_STEPS), str(tmp / "ckpt")],
        env=dict(env, RANK=str(r), WORLD_SIZE=str(WORLD), INIT=init),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in ranks]
        ref_log = ref.communicate(timeout=TIMEOUT)[0]
    finally:
        for p in ranks + [ref]:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(ranks, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    assert ref.returncode == 0, ref_log
    return (inp, dict(np.load(tmp / "ref.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)])


def test_two_pods_bitwise_and_at_the_bound(runs):
    """n = 2 with large cancellation between the pods: the compensated
    exchange is the reference's bits on both pods, at the reference's
    bound against f64, and no worse than the plain sum."""
    inp, ref, port = runs
    a, b = inp["pods_a"], inp["pods_b"]
    exact = np.float64(a) + np.float64(b)
    for r in range(2):
        np.testing.assert_array_equal(port[r]["pods_kahan"],
                                      ref["pods_kahan"][r])
    err_k = np.abs(port[0]["pods_kahan"] - exact).max()
    err_p = np.abs(port[0]["pods_naive"] - exact).max()
    assert err_k <= err_p + 1e-9, (err_k, err_p)
    assert err_k <= 8 * np.finfo(np.float32).eps * np.abs(
        np.float64(a)).max()
    np.testing.assert_array_equal(port[0]["pods_naive"], ref["pods_psum"][0])


def test_ring_of_eight_bitwise(runs):
    """n = 8: the (sum, carry) ring reduce-scatter + all-gather and the
    naive ring are the reference's bits on every rank; the compensated
    error stays within 16 eps sum|x|, and the naive ring's mean error is
    no smaller."""
    inp, ref, port = runs
    x = inp["ring_x"]
    exact = np.sum(np.float64(x), axis=0)
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r]["ring_kahan"],
                                      ref["ring_kahan"][r])
        np.testing.assert_array_equal(port[r]["ring_naive"],
                                      ref["ring_naive"][r])
    err = np.abs(port[0]["ring_kahan"] - exact)
    bound = 16 * np.finfo(np.float32).eps * np.sum(np.abs(np.float64(x)),
                                                   axis=0) + 1e-20
    assert (err <= bound).all(), float(err.max())
    assert err.mean() <= np.abs(port[0]["ring_naive"] - exact).mean() + 1e-9


def test_ef_int8_all_reduce(runs):
    """EF int8 at n = 4 over 30 steps: every step's output and the final
    residual within 16 eps max|g| of the reference's on every pod (see
    the module's docstring), and the accumulated mean converges to the
    true sum (err < 0.02 max|g|)."""
    inp, ref, port = runs
    g = inp["ef_g"]
    tol = 16 * np.finfo(np.float32).eps * np.abs(g).max()
    for r in range(WORLD):
        pod = int(port[r]["ef_pod"])
        np.testing.assert_allclose(port[r]["ef_outs"],
                                   ref["ef_outs"][:, pod], rtol=0, atol=tol)
        np.testing.assert_allclose(port[r]["ef_resid"],
                                   ref["ef_resid"][pod], rtol=0, atol=tol)
    err = np.abs(port[0]["ef_outs"].sum(0) / EF_STEPS - g.sum(0)).max()
    assert err < 0.02 * np.abs(g).max(), err


def test_tree_all_reduce(runs):
    """``make_all_reduce_fn``: every leaf of each rank's tree is the
    compensated sum over the pods' axis."""
    inp, _, port = runs
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r]["tree_a"],
                                      port[0]["tree_a"])
    exact = np.sum(np.float64(inp["ef_g"]), 0)
    assert np.abs(port[0]["tree_a"] - exact).max() <= 4 * np.finfo(
        np.float32).eps * np.abs(np.float64(inp["ef_g"])).sum(0).max()
    np.testing.assert_array_equal(port[0]["tree_b"],
                                  2 * port[0]["tree_a"])
    assert port[0]["tree_a"].shape == inp["ef_g"].shape[1:]


def test_pipeline_against_the_reference(runs):
    """GPipe, S = 4 stages and M = 6 microbatches: the forward on every
    rank and each stage's gradient of sum(out^2) within 1e-5 of the
    reference's (its own test asks only for a finite gradient); each
    stage's gradient lands in its own slice."""
    _, ref, port = runs
    for r in range(WORLD):
        np.testing.assert_allclose(port[r]["pipe_out"], ref["pipe_out"],
                                   atol=1e-5, rtol=1e-5)
        s = int(port[r]["pipe_stage"])
        np.testing.assert_allclose(port[r]["pipe_grad"], ref["pipe_grad"][s],
                                   atol=1e-5, rtol=1e-5)
        assert float(port[r]["pipe_grad_others"]) == 0.0
    assert {int(p["pipe_stage"]) for p in port} == {0, 1, 2, 3}


def test_meshes_and_elastic_remesh(runs):
    """The test meshes' axes and shapes; a checkpoint saved under the
    (2, 2, 2) mesh restores under (4, 2) with each rank's local shard
    bitwise the matching slice, and whole without shardings."""
    _, _, port = runs
    full_w = np.arange(64, dtype=np.float32).reshape(8, 8)
    for r in range(WORLD):
        p = port[r]
        assert p["test_mesh"].tolist() == [4, 2]
        assert p["test_mesh_names"].tolist() == ["data", "model"]
        assert p["test_mesh_pod"].tolist() == [2, 2, 2]
        assert int(p["latest"]) == 7
        i, j = p["coord_b"].tolist()
        np.testing.assert_array_equal(p["w_local"],
                                      full_w[2 * i:2 * i + 2,
                                             4 * j:4 * j + 4])
        np.testing.assert_array_equal(p["b_local"], np.ones(4, np.float32))
        np.testing.assert_array_equal(p["w_full"], full_w)
        assert int(p["step_local"]) == 7
        assert p["w_mesh"].tolist() == [4, 2]
        np.testing.assert_array_equal(p["b_plain"], np.ones(8, np.float32))
        assert not bool(p["plain_is_dtensor"])


def test_shard_act_lays_out_a_dtensor(runs):
    """Inside ``activation_sharding`` a replicated [8, 4, 4, 2] DTensor
    goes to batch over "data" and heads over "model", its values
    unchanged."""
    _, _, port = runs
    for p in port:
        assert p["act_placements"].tolist() == ["S(0)", "S(2)"]
        assert bool(p["act_same"])


def test_save_in_a_group_is_published_on_every_rank(runs):
    """``save`` with the default ``async_save`` in an 8-rank group, with
    no barrier of the caller's: every rank's ``latest_step`` and
    ``restore`` right after it see the new step whole."""
    _, _, port = runs
    for p in port:
        assert int(p["latest_8"]) == 8
        np.testing.assert_array_equal(p["b_8"], np.full(8, 2, np.float32))


@pytest.mark.parametrize("arch", [a for a, _ in BLOCKS])
def test_block_forward_under_activation_sharding(runs, arch):
    """One reduced layer's training forward with DTensor parameters (laid
    out by ``param_specs`` on the (4, 2) mesh) and a batch-sharded h,
    inside ``activation_sharding``: every ``shard_act`` site it passes
    gets a DTensor and lays it out over both mesh axes (batch over data,
    heads over model), and the result is the plain forward's to within
    one bf16 step of each element, with at most 1 in 1000 elements
    apart (bitwise in this container). The sharded products sum their
    f32 partials over the FSDP axis in another order, which a bf16
    rounding can show; rounding the partials to bf16 before summing
    them (DTensor's cast of a ``Partial`` tensor, which
    ``sharding.reduce_partial`` in ``common.dense`` prevents) moved 62%
    of the elements, by up to two steps."""
    _, _, port = runs
    for p in port:
        want = p[f"block_{arch}_want"]
        got = p[f"block_{arch}_got"]
        seen = p[f"block_{arch}_seen"]
        assert len(seen) >= 1
        assert all("R" not in s for row in seen for s in row), seen
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                   2.0 ** -126))) - 7)
        assert (np.abs(got - want) <= step).all()
        assert (got != want).mean() <= 1e-3, (got != want).mean()


# the layout each knob case's own site must show, (data, model)
KNOB_SITE = {"olmoe-1b-7b": ["R", "S(0)"],
             "qwen1.5-0.5b+sp_residual": ["S(0)", "S(1)"]}


@pytest.mark.parametrize("name", [n for n, _, _ in KNOB_BLOCKS])
def test_knob_block_forward_under_activation_sharding(runs, name):
    """The same as ``test_block_forward_under_activation_sharding`` for
    the dry run's two other sites: a reduced olmoe layer (MoE's expert
    site lays the [E, C, d] buckets out over the model axis, experts per
    rank, after the router's outputs are gathered and routed whole) and a
    reduced qwen1.5 layer under ``sp_residual`` (the residual entering
    the layer over batch and sequence). Each site is seen with its
    layout, and the forward is the plain one's to within one bf16 step
    of each element, at most 1 in 1000 elements apart."""
    _, _, port = runs
    for p in port:
        want = p[f"block_{name}_want"]
        got = p[f"block_{name}_got"]
        seen = [list(row) for row in p[f"block_{name}_seen"]]
        assert KNOB_SITE[name] in seen, seen
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                   2.0 ** -126))) - 7)
        assert (np.abs(got - want) <= step).all()
        assert (got != want).mean() <= 1e-3, (got != want).mean()
        if f"block_{name}_routing" in p:
            # MoE: each batch shard (4 of [4, 32] tokens) routes its own
            # 32 tokens (64 assignments), bitwise the single process's
            # routing of them
            assert p[f"block_{name}_routing"].all()
            assert p[f"block_{name}_route_rows"].tolist() == [32, 64]
    if name.startswith("olmoe"):
        assert all(f"block_{name}_routing" in p for p in port)


@pytest.mark.parametrize("name", [n for n, *_ in MOE_CASES])
def test_moe_dispatch_kept_over_the_batch(runs, name):
    """The MoE layer on 8 ranks, (data 4, model 2), tokens [8, 16]
    split over data and the 8 experts over model (and on (pod 2, data 2,
    model 2) with the tokens over pod and data, the experts' d over
    data: ``MOE_CASES``), forward and backward,
    against the single process on the same tensors. On inputs pinned
    away from router near-ties (the top-k gap checked), each batch
    shard's routing of its own 32 tokens (top-k experts, slots, keeps,
    global counts) is bitwise the single process's, and so is the drop
    fraction; every routing tensor carries 32 tokens (T / 4) or their
    64 pairs, never the 128; y, the aux losses and every gradient
    (router, experts, x) within ``MOE_RTOL`` relative norm. Bitwise
    here but the aux losses' means (summed per shard, then over them)
    and x's gradient (router and dispatch summed in another order)."""
    _, _, port = runs
    for p in port:
        assert float(p[f"moe_{name}_gap"]) > 1e-4
        assert p[f"moe_{name}_routing"].all()
        assert set(p[f"moe_{name}_rows"].tolist()) <= {32, 64, 8}
        drop = p[f"moe_{name}_drop"]
        assert drop[0] == drop[1]
        assert float(p[f"moe_{name}_y"]) <= MOE_RTOL
        assert (p[f"moe_{name}_aux"] <= MOE_RTOL).all()
        assert (p[f"moe_{name}_grads"] <= MOE_RTOL).all(), \
            p[f"moe_{name}_grads"]
        # the mesh run's product gradients came through the card's
        # autograd forms, each DTensor's partials summed before rounding
        assert int(p[f"moe_{name}_summed"]) > 0
    if name == "contested":
        assert port[0][f"moe_{name}_drop"][0] > 0.5


def _bf16_steps(got, want):
    """|got - want| in bf16 steps of each element of want."""
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                   - 7)
    return np.abs(got - want) / step


@pytest.mark.parametrize("name", [n for n, _ in GRAD_BLOCKS])
def test_block_gradients_under_activation_sharding(runs, name):
    """A reduced qwen1.5 layer forward and backward on 8 ranks, (data 4,
    model 2), its parameters laid out by ``param_specs`` and h over the
    batch, against the plain layer on the same tensors: the SwiGLU MLP
    with its gate/up kept split over the model axis (the fused weight's
    columns relaid per shard: every SwiGLU call holds d_ff / 2 of the
    hidden dim), and the same under ``sp_residual`` (the residual split
    over batch and sequence, the norms' outputs gathered over the
    sequence before the products: no product takes rows split over the
    sequence). The output and every gradient leaf (norms, attention, the
    MLP, h) within one bf16 step of each element of the plain one's, the
    output with at most 1 in 1000 elements apart: the sharded products
    sum their f32 partials in another order before they round, and the
    f32 gradients of the norms' scales sum their rows over the batch
    shards in another order (f32 ulps apart in about half of them)."""
    _, _, port = runs
    for p in port:
        # each rank holds its own half of the hidden dim (d_ff over the
        # 2-way model axis), never the whole gate/up pair
        *widths, d_ff = p[f"grad_{name}_widths"].tolist()
        assert widths and set(widths) == {d_ff // 2}, (widths, d_ff)
        # no product takes rows split over the sequence (with the batch
        # over data, a [B * L] row dim split over two mesh dims)
        taken = p[f"grad_{name}_taken"].tolist()
        assert taken and all("S(1)" not in q for q in taken), taken
        y = p[f"grad_{name}_y"]
        assert (_bf16_steps(y[1], y[0]) <= 1).all()
        assert (y[1] != y[0]).mean() <= 1e-3
        names = p[f"grad_{name}_names"].tolist()
        assert "/ffn/w_gate_up" in names and "h" in names
        for key in names:
            want, got = p[f"grad_{name}_{key}"]
            assert np.abs(want).max() > 0, key
            assert (_bf16_steps(got, want) <= 1).all(), (
                key, float(_bf16_steps(got, want).max()))
