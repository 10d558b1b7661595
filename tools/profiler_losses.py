"""What makes ``torch.profiler`` lose device events on this card: a
one-rank NCCL group, its end, ``chip_smoke.phase_dist``'s steps, many
launches, or time alone.

    python3 tools/profiler_losses.py [--windows N] [--child C] [--out FILE]

``chip_smoke.py``'s ``[dist]`` phase starts a one-rank NCCL group
(``launch.mesh.make_local_mesh``) and destroys it at its end. When that
phase ran before ``[times]``, the profiler showed no kernel of a
``fused_reduce`` call in five windows running. This script opens ``N``
profiler windows of each of four kinds (the L2 flush alone; one B2f
call, ``distributed.collectives.pre_reduce_stats`` on 2^20 f32; twenty
such calls, each after a flush, as ``chip_smoke.kernel_ms`` opens them;
one SDPA call) at each stage of these child processes (``--child``
runs one, printing its line):

- ``group``: ``fresh`` (no process group yet), ``mesh`` (after
  ``make_local_mesh``: NCCL's communicator is made lazily, so none yet),
  ``comm`` (after a ``dist.barrier``, which makes it), ``destroyed``
  (after ``destroy_process_group``);
- ``phase``: ``fresh``, then ``chip_smoke.phase_dist`` itself at full
  width, with windows after each of its steps (where it reads its
  clock for the step's seconds: ``mesh``, ``stats``, ``n = 1``, ``EF``,
  ``checkpoint``, the last after the group's end);
- ``stats``: ``phase_dist``'s ``stats`` step in parts: ``init`` (the
  f32 tree of qwen1.5-0.5b on the card), ``pre_reduce`` (one B2f call
  per leaf), ``twins`` (the plain twin over the leaves of each shape as
  rows), ``f64`` (each leaf's f64 sums and its maxabs, read to the
  host);
- ``launches``: after 2^20, 1.5 x 2^20, 2^21 -+ 2^14 and 3 x 2^20
  launches in all of one tiny elementwise kernel (``add_`` on 256
  floats), with no window open;
- ``idle``: after 20 s, then 60 s more, of sleep: no launch at all.

Each stage's windows follow its step at once, so a stage also tells
how long the process went without a window. For each stage it counts
the windows with no device event and the
windows whose device-kernel counts differ from what the same kind shows
in its ``fresh`` stage, and keeps the first such window of each kind.
Prints one JSON line per child (also written to ``--out``) and exits
non-zero when the card is missing or any child failed. Needs one CUDA
GPU; all five children take ~7 min.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LAUNCH_STAGES = (1 << 20, 3 << 19, (1 << 21) - (1 << 14),
                 (1 << 21) + (1 << 14), 3 << 20)
IDLE_STAGES = (20, 60)
CHILDREN = ("group", "phase", "stats", "launches", "idle")


def windows(n: int) -> dict:
    """``n`` windows of each kind: kind -> list of {kernel: launches}."""
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from repro_torch.distributed import collectives
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    x = torch.randn(1 << 20, generator=g, device=dev)
    q = torch.randn(4, 16, 2048, 64, generator=g, device=dev).bfloat16()
    kinds = {
        "flush": (flush.zero_, None, 1),
        "b2f": (lambda: collectives.pre_reduce_stats(x), None, 1),
        "b2f x20 flushed": (lambda: collectives.pre_reduce_stats(x), flush,
                            20),
        "sdpa": (lambda: F.scaled_dot_product_attention(q, q, q,
                                                        is_causal=True),
                 None, 1),
    }
    for fn, _, _ in kinds.values():
        fn()
    torch.cuda.synchronize()
    return {kind: [{k: c for k, (c, _) in chip_smoke._launches(
                fn, fl, reps).items()} for _ in range(n)]
            for kind, (fn, fl, reps) in kinds.items()}


def summary(stage: dict, fresh: dict) -> dict:
    """Per kind: windows with no device event, and windows whose counts
    differ from the fresh stage's most common counts."""
    out = {}
    for kind, wins in stage.items():
        want = Counter(json.dumps(w, sort_keys=True)
                       for w in fresh[kind]).most_common(1)[0][0]
        out[kind] = {"windows": len(wins),
                     "empty": sum(1 for w in wins if not w),
                     "differ": sum(1 for w in wins
                                   if json.dumps(w, sort_keys=True) != want),
                     "want": json.loads(want),
                     "first_differing": next(
                         (w for w in wins
                          if json.dumps(w, sort_keys=True) != want), None)}
    return out


def child(which: str, n: int) -> dict:
    import torch
    import torch.distributed as dist
    import chip_smoke
    from repro_torch import device as _device
    from repro_torch.launch import mesh as lmesh
    _device.set_numerics()
    dev = torch.device("cuda")
    stages = {"fresh": windows(n)}
    if which == "group":
        lmesh.make_local_mesh()
        stages["mesh"] = windows(n)
        dist.barrier()
        torch.cuda.synchronize()
        stages["comm"] = windows(n)
        dist.destroy_process_group()
        stages["destroyed"] = windows(n)
    elif which == "stats":
        from repro_torch.configs import get_config
        from repro_torch.core import kahan
        from repro_torch.distributed import collectives
        from repro_torch.kernels import engine
        from repro_torch.models import api
        tree = api.init_params(get_config("qwen1.5-0.5b"), device=dev,
                               seed=27, hold_bf16=False)
        leaves = kahan.tree_leaves(tree)
        torch.cuda.synchronize()
        stages["init"] = windows(n)
        for x in leaves:
            collectives.pre_reduce_stats(x)
        torch.cuda.synchronize()
        stages["pre_reduce"] = windows(n)
        by_shape: dict = {}
        for x in leaves:
            by_shape.setdefault(tuple(x.shape), []).append(x)
        for xs in by_shape.values():
            engine.fused_reduce_rows_plain(
                (torch.stack([x.reshape(-1) for x in xs]),),
                outputs=("sum", "sumsq", "maxabs"))
        torch.cuda.synchronize()
        stages["twins"] = windows(n)
        for x in leaves:
            x64 = x.double().reshape(-1)
            float(x64.sum()), float((x64 * x64).sum()), float(x.abs().max())
        stages["f64"] = windows(n)
    elif which == "launches":
        y = torch.zeros(256, device=dev)
        done = 0
        for total in LAUNCH_STAGES:
            for _ in range(total - done):
                y.add_(1.0)
            torch.cuda.synchronize()
            done = total
            stages[f"{total} launches"] = windows(n)
    elif which == "idle":
        import time
        for secs in IDLE_STAGES:
            time.sleep(secs)
            stages[f"{secs} s idle"] = windows(n)
    else:
        import time
        from repro_torch.configs import get_config
        marks = iter(("start", "mesh", "stats", "n = 1", "EF",
                      "checkpoint"))

        class Clock:
            """``time`` for chip_smoke: each clock read of phase_dist
            itself (its step marks) first takes the windows."""
            def __getattr__(self, name):
                return getattr(time, name)

            @staticmethod
            def perf_counter():
                if sys._getframe(1).f_code.co_name == "phase_dist":
                    mark = next(marks, "start")     # the log's read too
                    if mark != "start":
                        stages[mark] = windows(n)
                return time.perf_counter()

        chip_smoke.time = Clock()
        chip_smoke.phase_dist(dev, get_config("qwen1.5-0.5b"))
        chip_smoke.time = time
    return {"child": which,
            "stages": {k: summary(v, stages["fresh"])
                       for k, v in stages.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=30)
    ap.add_argument("--child",
                    choices=CHILDREN)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.child, args.windows)), flush=True)
        return 0
    results, rc = [], 0
    for which in CHILDREN:
        run = subprocess.run(
            [sys.executable, __file__, "--child", which,
             "--windows", str(args.windows)], cwd=ROOT,
            capture_output=True, text=True, env=dict(os.environ))
        last = (run.stdout.strip().splitlines() or [""])[-1]
        if run.returncode or not last.startswith("{"):
            rc = 1
            print(f"[profiler-nccl] child {which} failed ({run.returncode}):"
                  f"\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}",
                  file=sys.stderr)
            continue
        results.append(json.loads(last))
        print(last, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
