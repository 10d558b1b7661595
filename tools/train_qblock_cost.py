"""What flash attention's per-query-block checkpoint costs a training step
on the card, and what it saves, against another tree of the port.

    python3 tools/train_qblock_cost.py [--roots build/parent . . build/parent]
        [--arch qwen1.5-0.5b] [--layers N] [--seq 2048] [--batch 4]
        [--out PATH]

For each ``--roots`` entry in turn (a checkout of the repo: this one, or
a ``git archive`` of another commit unpacked under ``build/``), a child
process imports that tree's ``repro_torch`` and runs ``--arch`` at full
width (all its layers, or ``--layers``; f32 parameters, remat per layer,
Kahan AdamW) for one training step of ``--batch`` sequences of ``--seq``
tokens (one microbatch; 2048 tokens walk 4 query blocks of 512) on the
card, after
a warm step: the peak device memory over the step
(``torch.cuda.max_memory_allocated``, and above what the arguments
held), the device busy ms and kernels of one profiled step
(``torch.profiler``), and the step's median ms by CUDA events over 3
steps. Beside each, that tree's dry run predicts the same step on a
one-device mesh on the CPU (its ``tools/dryrun_predict.py``: argument
bytes and peak temporaries; a tree whose tool lacks ``--layers`` reports
the error). Run the roots in turns (parent, change, change, parent) so
that both see the same host. The card's name and power limit come
first. Prints one JSON object as its last line (also
written to ``--out``). Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROFILE_TRIES = 3


def child(root: Path, arch: str, layers: int | None, seq: int,
          batch: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    dev = torch.device("cuda")
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.with_(num_layers=layers)
    params = api.init_params(cfg, device=dev, seed=0, hold_bf16=False)
    opt_cfg = adamw.AdamWConfig(kahan=True)
    state = adamw.init(params, opt_cfg)
    g = torch.Generator().manual_seed(0)
    data = {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=g,
                              dtype=torch.int64).to(v.dtype)
                if v.dtype == torch.int32 else torch.ones(v.shape,
                                                          dtype=v.dtype))
            .to(dev) for k, v in synthetic.train_batch_struct(
                cfg, seq, batch).items()}
    train = steps.build_train_step(cfg, opt_cfg)
    box = [params, state]
    del params, state

    def one():
        box[0], box[1], metrics = train(box[0], box[1], data, 0)
        return metrics
    loss = float(one()["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    one()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        one()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        kern = [ev for ev in prof.key_averages()
                if getattr(ev, "device_type", None) == DeviceType.CUDA]
        if kern:
            break

    def us(ev):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(ev, attr):
                return float(getattr(ev, attr))
        return 0.0
    return dict(loss=loss, peak_bytes=peak, peak_above_args=peak - base,
                args_bytes=base, step_ms=statistics.median(ms),
                busy_ms=sum(us(ev) for ev in kern) / 1e3,
                kernels=sum(ev.count for ev in kern),
                profile_tries=attempt + 1)


def predicted(root: Path, arch: str, layers: int | None, seq: int,
              batch: int) -> dict:
    """The tree's dry-run prediction of the same step on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="4")
    r = subprocess.run(
        [sys.executable, str(root / "tools" / "dryrun_predict.py"),
         "--arch", arch, "--train-seq", str(seq), "--train-batch",
         str(batch)] + ([] if layers is None else ["--layers", str(layers)]),
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        return dict(error=r.stderr[-2000:])
    train = json.loads(r.stdout.strip().splitlines()[-1])["train"]
    return dict(arg_bytes=train["arg_bytes"], peak_bytes=train["peak_bytes"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child).resolve(), args.arch,
                               args.layers, args.seq, args.batch)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    preds = {}
    for root in args.roots:
        path = (ROOT / root).resolve()
        r = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             str(path), "--arch", args.arch, "--seq", str(args.seq),
             "--batch", str(args.batch)]
            + ([] if args.layers is None else ["--layers", str(args.layers)]),
            capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        run = dict(root=root, **json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(run), flush=True)
        runs.append(run)
    for root in dict.fromkeys(args.roots):
        preds[root] = predicted((ROOT / root).resolve(), args.arch,
                                args.layers, args.seq, args.batch)
        print(f"{root}: predicted {json.dumps(preds[root])}", flush=True)
    line = json.dumps(dict(card=smi, arch=args.arch, layers=args.layers,
                           seq=args.seq, batch=args.batch, runs=runs,
                           predicted=preds))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
