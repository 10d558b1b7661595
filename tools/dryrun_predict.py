"""The dry run's predictions for a step a single card also runs.

    PYTHONPATH=src python3 tools/dryrun_predict.py [--arch qwen1.5-0.5b]
        [--layers N] [--slots 8] [--context 1024] [--train-seq 2048]
        [--train-batch 4] [--control] [--out PATH]

Traces, on a one-rank ``"fake"`` group and a (1, 1) mesh, on the CPU,
the serve step of ``--slots`` slots over a ``--context``-token paged
cache (blocks of 16) and the Kahan AdamW train step of ``--train-batch``
sequences of ``--train-seq`` tokens, each as ``launch.dryrun`` traces a
cell (depth extrapolated; ``--layers`` cuts the model to N layers
first): argument bytes, peak temporaries, flops,
bytes and the three roofline terms on an H100 SXM. ``chip_smoke.py``'s
``[dryrun]`` phase runs the same steps on the card and holds the
argument bytes and peaks to these.

``--control`` gives the row norm's fake an output one row short; the
trace must then fail, and the script reports whether it did.

Prints one JSON object as its last line (also written to ``--out``).
Needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def one_device_mesh():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_local_mesh
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=1)
    return make_local_mesh(device="cpu")


def predict(arch: str, kind: str, seq_len: int, batch: int, mesh,
            layers: int | None = None) -> dict:
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.ecm import hopper_roofline
    from repro_torch.launch import dryrun
    shape = ShapeCell(f"chip_{kind}", kind, seq_len, batch)
    cfg = (None if layers is None else
           dryrun.config_for(arch).with_(num_layers=layers))
    cost, full = dryrun.cell_cost(arch, shape.name, False, mesh=mesh,
                                  shape=shape, cfg=cfg)
    _, _, meta, cfg, _, arg_bytes, _, _ = full
    report = hopper_roofline.roofline_from_cost(
        arch=arch, shape=shape.name, mesh=meta["mesh"], chips=1, cost=cost,
        model_flops=dryrun.model_flops(cfg, shape),
        bytes_per_chip=arg_bytes + cost.peak_bytes,
        mesh_shape={"data": 1, "model": 1})
    return dict(arg_bytes=int(arg_bytes), peak_bytes=int(cost.peak_bytes),
                flops=cost.flops, bytes=cost.bytes_accessed,
                kernel_calls=cost.kernel_calls,
                bound_ms=1e3 * max(report.t_compute_s, report.t_memory_s,
                                   report.t_collective_s),
                dominant=report.dominant)


def control(arch: str, seq_len: int, batch: int, mesh) -> str | None:
    """The serve step traced with the row norm's fake one row short: the
    error it raised, or None if it passed (the control failed)."""
    import dataclasses

    import torch

    from repro_torch.kernels import traced
    real = traced.FAKES["row_norm"]

    def short(x, weight, bias, eps):
        return torch.empty((x.shape[0] - 1,) + tuple(x.shape[1:]),
                           dtype=x.dtype, device=x.device)
    traced.FAKES["row_norm"] = dataclasses.replace(real, outputs=short)
    try:
        predict(arch, "decode", seq_len, batch, mesh)
    except Exception as e:                  # noqa: BLE001 (any failure)
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    finally:
        traced.FAKES["row_norm"] = real
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--context", type=int, default=1024)
    ap.add_argument("--train-seq", type=int, default=2048)
    ap.add_argument("--train-batch", type=int, default=4)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    mesh = one_device_mesh()
    out = {"arch": args.arch,
           "serve": predict(args.arch, "decode", args.context, args.slots,
                            mesh, args.layers),
           "train": predict(args.arch, "train", args.train_seq,
                            args.train_batch, mesh, args.layers)}
    if args.control:
        out["control_error"] = control(args.arch, args.context, args.slots,
                                       mesh)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
