"""The production dry run (``repro_torch.launch.dryrun``), its per-device
step counts (``ecm.step_cost``), its roofline (``ecm.hopper_roofline``)
and the card kernels' operators (``kernels.traced``), on the CPU.

Every test that starts a ``"fake"`` process group runs in a subprocess
of its own (as the reference's distributed tests run theirs), so that no
fake default group reaches another test on the same worker; the
reference's ``model_flops`` / ``enumerate_cells`` are read in a
subprocess too, since importing ``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 host devices.

Exactness: the counts are sums of integers (flops, bytes, ring-weighted
collective bytes, all far below 2^53), so the known answers, the
depth-and-block extrapolation against a full trace and the port's
``model_flops`` against the reference's are held with ``==``.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def run_script(body: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                       capture_output=True, text=True, timeout=TIMEOUT,
                       env=env, cwd=REPO)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


def test_list_and_model_flops_equal_the_reference(capsys):
    """``--list`` prints the reference's cells in its order, and
    ``model_flops`` equals the reference's on every cell."""
    ref = _last_json(run_script("""
        import json
        from repro.configs import SHAPES, get_config
        from repro.launch import dryrun
        print(json.dumps([[a, s, dryrun.model_flops(get_config(a), SHAPES[s])]
                          for a, s in dryrun.enumerate_cells()]))
    """))
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    dryrun.main(["--list"])          # prints only: starts no group
    listed = capsys.readouterr().out.strip().splitlines()
    assert listed == [f"{a:28s} {s}" for a, s, _ in ref]
    assert [list(c) for c in dryrun.enumerate_cells()] == \
        [[a, s] for a, s, _ in ref]
    for a, s, flops in ref:
        assert dryrun.model_flops(get_config(a), SHAPES[s]) == flops, (a, s)
    assert len(ref) == 32


# the fake-group cases, in one subprocess: the step counter's known
# answers, the trip-count rule, the mini dry run
FAKE_GROUP = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
import torch.distributed._functional_collectives as funcol
from repro_torch.ecm import step_cost
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_test_mesh(device="cpu")              # (data 4, model 2)
groups = dryrun.mesh_groups(mesh)
out = {}
with FakeTensorMode():
    def dt(local, pl):
        return DTensor.from_local(torch.empty(local), mesh, pl,
                                  run_check=False)
    a = dt((8, 64), [Shard(0), Replicate()])     # [32, 64], rows on data
    b = dt((64, 64), [Replicate(), Shard(1)])    # [64, 128], N on model
    with step_cost.StepCounter(groups) as c:
        y = a @ b
    out["sharded"] = [c.cost.dot_flops, c.cost.bytes_accessed,
                      c.cost.weighted_collective_bytes, str(y.placements)]
    a = dt((32, 32), [Replicate(), Shard(1)])    # [32, 64], K on model
    b = dt((32, 128), [Replicate(), Shard(0)])   # [64, 128], K on model
    with step_cost.StepCounter(groups) as c:
        y = a @ b
        placed = str(y.placements)
        y = y.redistribute(mesh, [Replicate(), Replicate()])
    out["partial"] = [c.cost.dot_flops, placed, c.cost.collective_bytes,
                      c.cost.axis_bytes]
    t = torch.empty(1024, 16)                    # 64 KiB f32
    with step_cost.StepCounter(groups) as c:
        funcol.all_reduce(t, "sum", (mesh, 0))
        funcol.all_gather_tensor(t, 0, (mesh, 1))
        funcol.reduce_scatter_tensor(t, "sum", 0, (mesh, 0))
        funcol.all_to_all_single(t, None, None, (mesh, 1))
    out["ring"] = [c.cost.collective_bytes, c.cost.axis_bytes,
                   c.cost.weighted_collective_bytes]
"""


def test_step_cost_known_answers(fake_group):
    """A row-and-column sharded product counts its local 2 |out| K; a
    product over a split K counts its half and leaves a partial sum,
    whose all-reduce over the model axis (n = 2) weighs 2 (n-1)/n of its
    bytes; each collective's ring factor over its group's size."""
    got = fake_group
    flops, nbytes, coll, placed = got["sharded"]
    assert flops == 2 * 8 * 64 * 64             # local [8, 64] x [64, 64]
    assert nbytes == 4 * (8 * 64 + 64 * 64 + 8 * 64)
    assert coll == 0 and placed == "(Shard(dim=0), Shard(dim=1))"
    flops, placed, raw, axis = got["partial"]
    assert flops == 2 * 32 * 128 * 32           # [32, 32] x [32, 128]
    assert placed == "(Replicate(), Partial(sum))"
    assert raw == {"all-reduce": 32 * 128 * 4}
    assert axis == {"model": 2 * (1 / 2) * 32 * 128 * 4}
    raw, axis, total = got["ring"]
    b = 1024 * 16 * 4
    assert raw == {"all-reduce": b, "all-gather": 2 * b,
                   "reduce-scatter": b, "all-to-all": b}
    # data n = 4, model n = 2
    want = {"data": 2 * 3 / 4 * b + 3 / 4 * b,
            "model": 1 / 2 * (2 * b) + 1 / 2 * b}
    assert axis == want and total == sum(want.values())


FAKE_GROUP += """
from repro_torch.configs import get_config, reduced
from repro_torch.configs.shapes import ShapeCell
cfg = reduced(get_config("qwen1.5-0.5b")).with_(num_layers=4)
out["trips"] = {}
for kind, seq in (("prefill", 128), ("decode", 128), ("train", 64)):
    shape = ShapeCell(kind, kind, seq, 8)
    c = cfg
    row = []
    for ext in (True, False):
        cost, _ = dryrun.cell_cost("qwen1.5-0.5b", kind, False, cfg=c,
                                   mesh=mesh, shape=shape, extrapolate=ext)
        row.append([cost.flops, cost.dot_flops, cost.elementwise_flops,
                    cost.bytes_accessed, cost.weighted_collective_bytes,
                    cost.kernel_calls])
    out["trips"][kind] = row
"""


def test_trip_count_rule_equals_a_full_trace(fake_group):
    """A 4-layer reduced qwen1.5 on the (4, 2) mesh: the depth cuts
    extrapolated to 4 layers, and serving's flash-attention block walks
    run once and counted for the 10 on or below the diagonal of 4 x 4,
    give the full trace's flops, bytes, collective bytes and kernel calls
    exactly."""
    got = fake_group["trips"]
    for case, (ext, full) in got.items():
        assert ext == full, case
        assert all(x > 0 for x in full[:4]), case
    # 4 query blocks: 10 key blocks walked (packed), 2 products each,
    # beside a layer's 6 dense products
    assert got["prefill"][1][5]["invariant_gemm"] == 4 * (6 + 2 * 10)


FAKE_GROUP += """
mesh = make_test_mesh(multi_pod=True, device="cpu")  # (2, 2, 2), same ranks
cfg = reduced(get_config("olmoe-1b-7b"))
cost, full = dryrun.cell_cost("olmoe-1b-7b", "mini", True, cfg=cfg,
                              mesh=mesh, shape=ShapeCell("mini", "train",
                                                         64, 8),
                              extrapolate=False)
out["mini"] = [cost.flops, cost.bytes_accessed,
               cost.weighted_collective_bytes, cost.kernel_calls,
               cost.axis_bytes, full[2]["mesh"], full[5]]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_group():
    return _last_json(run_script(FAKE_GROUP))


def test_mini_dryrun_on_test_mesh(fake_group):
    """The twin of the reference's ``test_mini_dryrun_on_test_mesh``:
    reduced olmoe (MoE's expert site), a (2, 2, 2) fake mesh, the Kahan
    AdamW train step traced as it stands: positive flops, bytes and
    collective bytes, B7's fake priced."""
    flops, nbytes, coll, kernels, axes, mesh, args = fake_group["mini"]
    assert flops > 0 and nbytes > 0 and coll > 0 and args > 0
    assert mesh == "2x2x2" and set(axes) <= {"pod", "data", "model"}
    assert kernels["kahan_acc"] > 0


# the extrapolated peak against full-depth traces: a 4-layer form of each
# depth_units family at full width, traced as a train step of 64
# sequences of 1024 tokens on the (4, 2) fake mesh (16 sequences a data
# shard, a production cell's activations per device), the forms two to
# a subprocess
PEAK_RTOL = 0.01
PEAK_FORMS = {"qwen1.5-0.5b": {"num_layers": 4},
              # segments of 3: one, then a tail layer, as zamba2's 38
              # layers end in a tail after their last shared block
              "zamba2-1.2b": {"num_layers": 4, "hybrid": {"segment_len": 3}},
              "whisper-tiny": {"num_layers": 2, "encdec": {"enc_layers": 2}},
              "deepseek-v2-236b": {"num_layers": 4, "first_k_dense": 1}}
PEAKS = """
import json, sys, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.ecm.step_cost import StepCost
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_test_mesh(device="cpu")
shape = ShapeCell("train", "train", 1024, 64)
out = {}
for arch, kw in json.loads(sys.argv[1]).items():
    cfg = get_config(arch)
    cfg = cfg.with_(**{k: getattr(cfg, k)._replace(**v) if isinstance(v, dict)
                       else v for k, v in kw.items()})
    cuts = dryrun.depth_cuts(cfg)
    costs = []
    for c in cuts:
        step, make, *_, m, rules = dryrun._build_cell(
            arch, "train", False, "kahan", (), cfg=c, mesh=mesh, shape=shape)
        costs.append(dryrun.trace_step(step, make, m, rules,
                                       extrapolate=True))
    coef = [float(x) for x in dryrun._solve(
        [dryrun.depth_units(c) for c in cuts], dryrun.depth_units(cfg))]
    full, _ = dryrun.cell_cost(arch, "train", False, cfg=cfg, mesh=mesh,
                               shape=shape, extrapolate=False)
    out[arch] = [StepCost.combine(zip(coef, costs)).peak_bytes,
                 sum(k * c.peak_bytes for k, c in zip(coef, costs)),
                 full.peak_bytes]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def peaks():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    names = list(PEAK_FORMS)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(PEAKS),
         json.dumps({a: PEAK_FORMS[a] for a in part})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for part in (names[:2], names[2:])]
    out = {}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
            out.update(_last_json(stdout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


@pytest.mark.parametrize("arch", list(PEAK_FORMS))
def test_extrapolated_peak_equals_a_full_trace(peaks, arch):
    """The peak the dry run extrapolates from its depth cuts
    (``StepCost.combine``: each phase's stacked set linearly, the
    transients on top) is a full-depth trace's to within ``PEAK_RTOL``
    (exact on these forms) for each family: one stack (qwen1.5), hybrid
    (zamba2), audio (whisper), ``first_k_dense`` (deepseek-v2)."""
    ext, _, full = peaks[arch]
    assert abs(ext / full - 1) <= PEAK_RTOL, (ext, full)


def test_linear_peak_misses_the_hybrid(peaks):
    """The control: the cuts' peaks summed with their depth coefficients
    (-1/2, 0, 3/2 here), the rule before, miss the hybrid's full trace
    by more than ``PEAK_RTOL``: its cuts peak in different layer kinds."""
    _, linear, full = peaks["zamba2-1.2b"]
    assert abs(linear / full - 1) > PEAK_RTOL, (linear, full)


ONE_RANK_CE = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.distributed.sharding import vocab_parallel_ce
from repro_torch.ecm import step_cost
from repro_torch.launch.mesh import make_local_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
mesh = make_local_mesh(device="cpu")                # (data 1, model 1)
g = torch.Generator().manual_seed(0)
lg = torch.randn(4, 32, 512, generator=g)
labels = torch.randint(0, 512, (4, 32), generator=g)

def plain(x):
    return (torch.logsumexp(x, dim=-1),
            torch.gather(x, -1, labels[..., None])[..., 0])

def split(x):
    return vocab_parallel_ce(DTensor.from_local(
        x, mesh, [Replicate(), Shard(2)], run_check=False), labels)

def run(fn):
    x = lg.clone().requires_grad_(True)
    with step_cost.StepCounter() as c:
        lse, ll = fn(x)
        (lse - ll).sum().backward()
    local = [t.to_local() if isinstance(t, DTensor) else t for t in (lse, ll)]
    return c.cost.peak_bytes, [t.detach() for t in local], x.grad
p_peak, p_out, p_grad = run(plain)
s_peak, s_out, s_grad = run(split)
print(json.dumps(dict(
    peaks=[p_peak, s_peak],
    bitwise=all(torch.equal(a, b) for a, b in zip(p_out + [p_grad],
                                                  s_out + [s_grad])))))
"""


def test_one_rank_vocab_split_runs_the_plain_loss():
    """A vocabulary split over mesh dims of one rank (a (1, 1) mesh, as
    ``tools/dryrun_predict.py`` traces for one card) is no split:
    ``vocab_parallel_ce`` gives the plain logsumexp and gather bitwise,
    values and gradient, and its backward holds what the plain one holds
    (the counter's peak equal), as the card's one-device step does. The
    split form's backward holds one [rows, V] f32 buffer fewer, which
    left the trace 4.98 GB under the card at qwen1.5's 4 x 2048."""
    got = _last_json(run_script(ONE_RANK_CE))
    assert got["bitwise"]
    plain, split = got["peaks"]
    assert split == plain > 0, got


def test_within_host_prices_the_production_axes():
    from repro_torch.ecm import hopper_roofline as hr
    from repro_torch.ecm.machines import H100_SXM
    single = {"data": 16, "model": 16}
    multi = {"pod": 2, "data": 16, "model": 16}
    # the model axis (16, inner) spans two 8-GPU hosts: the network's rate
    for mesh in (single, multi):
        assert all(hr.axis_bw(mesh, a) == H100_SXM["net_bw"] for a in mesh)
    test = {"data": 4, "model": 2}
    assert all(hr.axis_bw(test, a) == H100_SXM["nvlink_bw"] for a in test)


# ------------------------------------------------------------ the fakes ----

def _fake_like_twin(name, twin, launch, *args, **kw):
    """The launcher's outputs on fake copies of the arguments (its
    operator's fake), against the plain twin's on the real ones: shapes
    and dtypes; the call priced by the operator's name."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.ecm import step_cost
    want = twin(*args, **kw)
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                 (type(a)(mode.from_tensor(t) for t in a)
                  if isinstance(a, tuple) else a) for a in args]
    fake_kw = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
    with mode, step_cost.StepCounter() as counter:
        got = launch(*fake_args, **fake_kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want], name
    assert counter.cost.kernel_calls == {name: 1.0}
    assert counter.cost.bytes_accessed > 0


def test_fakes_return_the_twins_shapes_and_dtypes():
    from repro_torch.kernels import engine, invariant_gemm, kahan_acc
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import row_norm, serving_head
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)
    x = rnd(3, 5, 64, dtype=torch.bfloat16)
    w, b = rnd(64), rnd(64)
    _fake_like_twin("row_norm", lambda x, w, *, eps:
                    row_norm.rms_norm_plain(x, w, eps=eps),
                    row_norm.row_norm_cuda, x, w, eps=1e-6)
    _fake_like_twin("row_norm", lambda x, w, b, *, eps:
                    row_norm.layer_norm_plain(x, w, b, eps=eps),
                    row_norm.row_norm_cuda, x, w, b, eps=1e-5)
    for xs, ws in (((7, 32), (32, 48)), ((4, 7, 32), (4, 32, 48)),
                   ((2, 3, 7, 32), (2, 3, 32, 48))):
        _fake_like_twin("invariant_gemm",
                        lambda x, w, *, plan_batch=None, route=None:
                        invariant_gemm.invariant_gemm_plain(x, w),
                        invariant_gemm.invariant_gemm_cuda,
                        rnd(*xs, dtype=torch.bfloat16),
                        rnd(*ws, dtype=torch.bfloat16), plan_batch=None)
    h = rnd(8, 64)
    _fake_like_twin("serving_head", serving_head.serving_head_plain,
                    serving_head.serving_head_cuda, h, rnd(64, 100))
    _fake_like_twin("serving_head", serving_head.serving_head_plain,
                    serving_head.serving_head_cuda, h, rnd(100, 64),
                    tied=True)
    bsz, mb, bs = 2, 4, 16
    table = torch.arange(bsz * mb, dtype=torch.int32).reshape(bsz, mb)
    lens = torch.full((bsz,), mb * bs, dtype=torch.int32)
    offs = lens - 1
    _fake_like_twin("paged_attention", pa.paged_attention_plain,
                    pa.paged_attention_cuda, rnd(bsz, 1, 4, 32, dtype=torch.bfloat16),
                    rnd(bsz * mb, bs, 2, 32, dtype=torch.bfloat16),
                    rnd(bsz * mb, bs, 2, 32, dtype=torch.bfloat16), table,
                    lens, offs)
    _fake_like_twin("paged_latent_attention",
                    pa.paged_latent_attention_plain,
                    pa.paged_latent_attention_cuda, rnd(bsz, 1, 4, 64, dtype=torch.bfloat16),
                    rnd(bsz, 1, 4, 16, dtype=torch.bfloat16),
                    rnd(bsz * mb, bs, 64, dtype=torch.bfloat16),
                    rnd(bsz * mb, bs, 16, dtype=torch.bfloat16), table,
                    lens, offs, scale=0.1)
    _fake_like_twin("fused_reduce", engine.fused_reduce_rows_plain,
                    engine.fused_reduce_rows_cuda, (rnd(3, 700), rnd(3, 700)),
                    outputs=("dot", "sum", "maxabs"))
    _fake_like_twin("kahan_acc", kahan_acc.kahan_acc_flat_plain,
                    kahan_acc.kahan_acc_flat_cuda, rnd(300), rnd(300), rnd(300, dtype=torch.bfloat16))


def test_a_traced_call_without_a_fake_raises():
    """A fake tensor that reaches a kernel with no fake (B4, B5) raises
    before anything is built or launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import traced
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.kahan_matmul import kahan_matmul_cuda
    with FakeTensorMode():
        q = torch.empty(2, 64, 32, dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="no fake"):
            flash_attention_cuda(q, q, q)
        a = torch.empty(64, 64)
        with pytest.raises(RuntimeError, match="no fake"):
            kahan_matmul_cuda(a, a)
    with pytest.raises(KeyError):
        traced.op("flash_attention")             # no operator either
    assert not traced.active(torch.empty(2))
