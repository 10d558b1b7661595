"""What a production cell keeps on each rank, traced on the (4, 2) fake
mesh (``launch.mesh.make_test_mesh``) as ``tests/test_torch_dryrun.py``
traces its cells: fake tensors laid out as DTensors, the card's path,
every storage the step makes recorded (``StepCounter(record=True)``,
``StepCost.made_tensors``: op, local shape, dtype, bytes).

  * ``sp_residual``: a 2-layer qwen1.5-0.5b train step traces with the
    residual split over batch and sequence (the norms' outputs gathered
    over the sequence before the products), its peak no higher than the
    baseline's;
  * the SwiGLU MLP on a model-split rank: no storage of a row block at
    the whole 2 d_ff width (the fused gate/up product gathered), and the
    f32 SiLU over the rank's own d_ff / 2 gate columns alone;
  * the one-shot prefill's pools of configs whose kv heads (3) do not
    divide the 2-way model axis come out laid out as
    ``serve_cache_shardings`` lays out the decode step's: head_dim over
    the model axis (GQA, int8 with its scale pools, MLA's latents);
  * MoE's combine: no [T / batch, k, d] tensor, at any point of the
    step, and on the (2, 2, 2) mesh (batch over pod and data, d over
    data) a plane of one row per token of this shard's size, with the
    pair indices of the batch shards along data alone.

All cases run in one subprocess (a ``"fake"`` default group must not
meet another test's group).
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

FIT = """
import json, math, traceback, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config, reduced
from repro_torch.configs.shapes import ShapeCell
from repro_torch.distributed import sharding
from repro_torch.kernels import traced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_test_mesh(device="cpu")              # (data 4, model 2)
out = {}

def train(arch, cfg, opts=(), seq=256, batch=16, on=mesh):
    step, make, *_, m, rules = dryrun._build_cell(
        arch, "train", False, "kahan", opts, cfg=cfg, mesh=on,
        shape=ShapeCell("train", "train", seq, batch))
    return dryrun.trace_step(step, make, m, rules, extrapolate=False,
                             record=True)

def case(name):
    # each case's result, or the error that stopped it
    def run(fn):
        try:
            out[name] = fn()
        except Exception:
            out[name] = {"error": traceback.format_exc()[-2000:]}
    return run

# the baseline, and sp_residual held to it
qwen = dryrun.config_for("qwen1.5-0.5b").with_(num_layers=2)
base = train("qwen1.5-0.5b", qwen)

@case("sp")
def _():
    sp = train("qwen1.5-0.5b", qwen.with_(sp_residual=True),
               ("sp_residual",))
    return [sp.peak_bytes, base.peak_bytes, sp.dot_flops, base.dot_flops]

out["mlp"] = [qwen.d_ff, 16 // 4 * 256,
              [[op, list(s), dt] for op, s, dt, _ in base.made_tensors]]

# MoE's combine: reduced olmoe, one layer, on (4, 2) and on the
# (pod 2, data 2, model 2) mesh, whose batch splits over two dims and d
# over one (2x16x16's placements)
moe = reduced(get_config("olmoe-1b-7b")).with_(num_layers=1)
for name, on in (("moe", mesh),
                 ("moe pod", make_test_mesh(multi_pod=True, device="cpu"))):
    @case(name)
    def _():
        c = train("olmoe-1b-7b", moe, seq=64, batch=8, on=on)
        return [8 // 4 * 64, moe.moe.top_k, moe.d_model,
                [list(s) for _, s, _, _ in c.made_tensors]]

# the one-shot prefill's pools against the decode step's rule
for name, arch, cfg in (
        ("gqa", "qwen1.5-0.5b",
         reduced(get_config("qwen1.5-0.5b")).with_(num_heads=3,
                                                  num_kv_heads=3)),
        ("gqa-int8", "qwen1.5-0.5b",
         reduced(get_config("qwen1.5-0.5b")).with_(
             num_heads=3, num_kv_heads=3, kv_dtype="int8")),
        ("mla", "deepseek-v2-236b", reduced(get_config("deepseek-v2-236b")))):
    @case("pools " + name)
    def _():
        step, make, *_, m, rules = dryrun._build_cell(
            arch, "prefill", False, "kahan", (), cfg=cfg, mesh=mesh,
            shape=ShapeCell("prefill", "prefill", 64, 8))
        with traced.card(), dryrun._card_collectives(), \\
                FakeTensorMode(allow_non_fake_inputs=True):
            args = make()
            with sharding.activation_sharding(m, rules):
                _, caches = step(*args)
        struct = {k: (tuple(v.shape), v.dtype) for k, v in caches.items()}
        want = sharding.serve_cache_shardings(cfg, struct, mesh, 8)
        return {k: [list(v.shape), [str(p) for p in v.placements],
                    [str(p) for p in want[k].placements()]]
                for k, v in caches.items() if hasattr(v, "placements")}
print(json.dumps(out))
"""


def _result(fit, name):
    got = fit[name]
    assert not (isinstance(got, dict) and "error" in got), got.get("error")
    return got


@pytest.fixture(scope="module")
def fit():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(FIT)],
                       capture_output=True, text=True, timeout=TIMEOUT,
                       env=env, cwd=REPO)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_sp_residual_train_step_traces(fit):
    """A 2-layer qwen1.5-0.5b train step (16 sequences of 256) traces
    under ``sp_residual`` on the (4, 2) mesh (a product of rows split
    over batch and sequence used to meet a strided shard there, which
    a fake tensor cannot lay out), runs the baseline's products (equal
    dot flops: the sequence is gathered before them) and peaks no
    higher than the baseline."""
    sp_peak, base_peak, sp_dots, base_dots = _result(fit, "sp")
    assert 0 < sp_peak <= base_peak
    assert sp_dots == base_dots > 0


def test_mlp_keeps_its_hidden_dim_split(fit):
    """qwen1.5-0.5b's SwiGLU MLP on a rank of the 2-way model axis: no
    storage of the step holds a token block at the whole 2 d_ff width
    (the fused product gathered before it splits into gate and up), and
    every f32 SiLU the step runs (forward and recompute) covers d_ff / 2
    columns, the rank's own gate columns, never the whole hidden dim."""
    d_ff, rows, made = fit["mlp"]
    whole = [(op, s, dt) for op, s, dt in made
             if s and s[-1] == 2 * d_ff and math.prod(s[:-1]) >= rows]
    assert not whole, whole[:4]
    silu = [s[-1] for op, s, _ in made if op == "silu"]
    assert silu and set(silu) == {d_ff // 2}, silu


def test_moe_combine_holds_no_whole_rows(fit):
    """Reduced olmoe (8 experts over the 2-way model axis, top 2): no
    storage of the train step is a [T / batch, k, d] block of each
    token's k expert rows; the combine moves a plane of one row per
    token at a time."""
    tokens, k, d, made = _result(fit, "moe")
    assert [tokens, k, d] not in made
    assert [tokens // 2, d] in made              # an expert shard's chunk


def test_moe_combine_plane_is_one_row_per_token(fit):
    """Reduced olmoe on the (pod 2, data 2, model 2) mesh: the batch
    splits over pod and data, the down projection's d over data alone.
    Each rank picks its slice d / 2 of the rows of the two batch shards
    along data (a plane [2 n, d / 2], n d elements) and gathers those
    two shards' pair indices [2 n, k]: no plane over all four shards'
    tokens [4 n, d / 2], and no index tensor at the global token count
    [4 n, k]."""
    n, k, d, made = _result(fit, "moe pod")
    assert [n, k, d] not in made
    assert [2 * n, d // 2] in made
    assert [4 * n, d // 2] not in made
    assert [4 * n, k] not in made


@pytest.mark.parametrize("name", ["gqa", "gqa-int8", "mla"])
def test_prefill_pools_laid_out_as_the_decode_steps(fit, name):
    """The one-shot prefill's stacked pools (and scale pools) come out
    laid out by ``serve_cache_shardings``'s rule, as the decode step of
    the same deployment takes them: blocks over data, the model axis on
    the first feature dim it divides, head_dim where 3 kv heads do not
    divide it, nothing where no feature dim does (the int8 scales)."""
    pools = _result(fit, "pools " + name)
    keys = {"gqa": {"kpool", "vpool"},
            "gqa-int8": {"kpool", "vpool", "kscale", "vscale"},
            "mla": {"c_kv", "k_rope"}}[name]
    assert keys <= set(pools)
    for key in keys:
        shape, got, want = pools[key]
        assert got == want, (key, shape, got, want)
    last = f"S({len(pools[min(keys)][0]) - 1})"
    assert pools[min(keys)][1][1] == last       # head_dim / latent dim
