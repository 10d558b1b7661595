"""The tensors that hold a dry-run cell's peak.

    PYTHONPATH=src python3 tools/dryrun_peak.py --arch olmoe-1b-7b
        --shape train_4k [--mesh single|multi] [--opts a,b]
        [--cut N | --full] [--top 12] [--walk rule|always]

Traces one cell as ``launch.dryrun`` does (a ``"fake"`` group of 256 or
512 ranks, fake tensors laid out as DTensors, the card's path), at each
of its depth cuts (``--cut N``: the N-th alone; ``--full``: the config
at its own depth instead), and prints for each trace its peak, its
phases' peaks and their stacked parts (``ecm.step_cost``) and the ``--top``
largest storages live at the peak: the op that made each, its local
shape, dtype and GB. Over all the cuts it then prints the extrapolated
peak the dry run reports. A storage that stacks with depth shows once
per layer. ``--walk always`` checkpoints every flash-attention walk of
more than one query block (the loss and the gradients past the first
layer taken to hold nothing), against
which the rule's choice (``attention.beside_loss``, the default) can be
read. Run it as a process of its own (it starts a fake group). Needs no
GPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def show(label: str, cost, top: int) -> None:
    gb = 1e9
    phases = ", ".join(
        f"{k} {v / gb:.2f} of which stacked {cost.phase_stacked[k][0] / gb:.2f}"
        f" (at most {cost.phase_stacked[k][1] / gb:.2f})"
        for k, v in cost.phase_peaks.items())
    print(f"{label}: peak {cost.peak_bytes / gb:.2f} GB ({phases}; end "
          f"{cost.end_bytes / gb:.2f})")
    for op, shape, dtype, n in cost.peak_tensors[:top]:
        print(f"  {n / gb:8.3f} GB  {op:28s} {list(shape)} "
              f"{dtype.replace('torch.', '')}")
    rest = cost.peak_tensors[top:]
    print(f"  {sum(r[3] for r in rest) / gb:8.3f} GB  in {len(rest)} more")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--variant", choices=["kahan", "naive"], default="kahan")
    ap.add_argument("--opts", default="")
    ap.add_argument("--cut", type=int, default=None)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--walk", choices=["rule", "always"], default="rule")
    args = ap.parse_args()
    from repro_torch.ecm.step_cost import StepCost
    from repro_torch.launch import dryrun
    from repro_torch.models import attention
    if args.walk == "always":
        attention.LOSS_BYTES_PER_LOGIT = {True: 0, False: 0}
        attention.grads_after_first_layer = lambda *a: 0
    opts = tuple(o for o in args.opts.split(",") if o)
    multi = args.mesh == "multi"
    cfg = dryrun.config_for(args.arch, args.variant, opts)
    cfgs = [cfg] if args.full else dryrun.depth_cuts(cfg)
    costs = []
    for i, c in enumerate(cfgs):
        if args.cut is not None and i != args.cut:
            continue
        step, make, _, _, _, _, mesh, rules = dryrun._build_cell(
            args.arch, args.shape, multi, args.variant, opts, cfg=c)
        cost = dryrun.trace_step(step, make, mesh, rules,
                                 extrapolate=not args.full, record=True)
        costs.append((c, cost))
        show(f"{args.arch} x {args.shape} x {args.mesh}, depth units "
             f"{dryrun.depth_units(c)}", cost, args.top)
    if len(costs) == len(cfgs) > 1:
        coef = dryrun._solve([dryrun.depth_units(c) for c, _ in costs],
                             dryrun.depth_units(cfg))
        peak, phases = StepCost.extrapolate_peak(
            [(float(k), cost) for k, (_, cost) in zip(coef, costs)])
        print(f"extrapolated to depth units {dryrun.depth_units(cfg)}: "
              f"peak {peak / 1e9:.2f} GB ("
              + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in phases.items())
              + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
