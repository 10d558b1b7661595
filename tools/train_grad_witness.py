"""How far does a training gradient move when only rounding changes, and
where do the card's and the CPU's gradients part?

    python3 tools/train_grad_witness.py [--arch ARCH ...] [--card]
                                        [--out PATH]

For each arch (default: chip_smoke's five ``TRAIN_FAMILIES``) at
``chip_smoke.small_config`` and both starts, the init as drawn
(``stacked``: a layer-stacked leaf at 1 / sqrt(layers), the reference's
rule) and ``fan-in`` (``chip_smoke.fan_in_scaled``: every product weight
at 1 / sqrt(its own K)), the step-0 gradient of ``TRAIN_FAMILY_SMALL_KW``'s
batch (Kahan accumulation of its 2 microbatches), as
``chip_smoke.family_cpu_parity`` takes it:

- the witness, on the CPU: the gradient with every bf16 product summed
  in f64 (then rounded to f32) against the port's f32 sums. Both are
  sound; what they part by is what rounding alone moves the gradient;
- with ``--card``: the card's gradient against the CPU's, and layer by
  layer from the same inputs, every bf16 product call in call order
  (both microbatches' forwards, by weight shape): its output on the card
  against the CPU's (the difference carried from earlier layers), the
  kernel's output against the plain twin on the card's own operands (the
  product's own), the incoming cotangent dY on the card against the
  CPU's, and each product backward on its own saved tensors against the
  plain version (``chip_smoke._ProductProbe``).

Differences are ||a - b|| / ||b||, the product weights' gradient as one
vector (``common.BF16_WEIGHTS`` leaves). Prints the card's name and
power limit first (with ``--card``) and one JSON object as the last line
(also written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


class CallTrace:
    """While open, records every ``invariant_gemm.product`` call: the
    weight's shape, the output (f32, on the host), the output against
    the twin on the same operands, and (by a hook) the incoming dY."""

    def __init__(self):
        from repro_torch.kernels import invariant_gemm as ig
        self.ig, self.product = ig, ig.product
        self.calls, self.dys = [], {}

    def __enter__(self):
        import chip_smoke as cs
        ig, product = self.ig, self.product

        def traced(x, w, **kw):
            y = product(x, w, **kw)
            i = len(self.calls)
            own = 0.0
            if y.is_cuda:
                own = cs._rel(y, ig.invariant_gemm_plain(x.detach(),
                                                         w.detach()))
            self.calls.append((tuple(w.shape), y.detach().float().cpu(),
                               own))
            if y.requires_grad:
                y.register_hook(lambda g, i=i: self.dys.__setitem__(
                    i, g.detach().float().cpu()))
            return y

        ig.product = traced
        return self

    def __exit__(self, *exc):
        self.ig.product = self.product


def gradient(arch: str, start: dict, device, *, f64: bool = False,
             trace: bool = False):
    """(named gradient leaves, the call trace or None, the probe's worst
    product backward or None) of ``start`` on ``device``."""
    import contextlib
    import torch
    import chip_smoke as cs
    from repro_torch.core import kahan
    from repro_torch.kernels import invariant_gemm as ig
    from repro_torch.models import api
    from repro_torch.optim import accumulate
    from repro_torch.train.loop import Trainer
    small = cs.small_config(arch)
    kw = dict(cs.TRAIN_FAMILY_SMALL_KW, seq_len=cs.TRAIN_FAMILY_SMALL_KW[
        "seq_len"] + (small.vlm.num_patches if small.vlm is not None else 0))
    t = Trainer(small, device=device, seed=cs.SEED, warmup=0, **kw)
    micro = accumulate.split_microbatches(
        t._device_batch(t.pipeline.batch_for_step(0)), kw["n_microbatches"])
    params = kahan.tree_map(lambda x: x.to(device, copy=True), start)
    plain = ig.invariant_gemm_plain
    with contextlib.ExitStack() as stack:
        if f64:
            ig.invariant_gemm_plain = lambda x, w: torch.matmul(
                x.to(torch.bfloat16).double(),
                w.to(torch.bfloat16).double()).float()
            stack.callback(setattr, ig, "invariant_gemm_plain", plain)
        tr = stack.enter_context(CallTrace()) if trace else None
        probe = (stack.enter_context(cs._ProductProbe())
                 if str(device) != "cpu" else None)
        grads = accumulate.accumulate_gradients(api.loss_fn(small), params,
                                                micro)[1]
    return (cs._named_leaves(grads), tr,
            None if probe is None else probe.worst)


def compare(got, want) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.models import common

    def vec(named, products: bool):
        return torch.cat([
            t.detach().reshape(-1).to("cpu", torch.float64)
            for n, t in named
            if not products or n.rsplit("/", 1)[-1] in common.BF16_WEIGHTS])

    worst = cs._worst(got, want)
    return dict(products=cs._rel(vec(got, True), vec(want, True)),
                whole=cs._rel(vec(got, False), vec(want, False)),
                worst_leaf=worst[0], worst_at=worst[1])


def layer_by_layer(card, cpu) -> list:
    """Per product call: (index, weight shape, output card vs CPU, the
    kernel's own vs its twin, dY card vs CPU)."""
    import chip_smoke as cs
    rows = []
    for i, ((shape, y, own), (_, y_cpu, _)) in enumerate(zip(card.calls,
                                                            cpu.calls)):
        dy = (cs._rel(card.dys[i], cpu.dys[i])
              if i in card.dys and i in cpu.dys else None)
        rows.append((i, list(shape), cs._rel(y, y_cpu), own, dy))
    return rows


def main() -> int:
    import chip_smoke as cs
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*",
                    default=[a for a, _, _ in cs.TRAIN_FAMILIES])
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from repro_torch import device as _device
    from repro_torch.models import api
    smi = None
    if args.card:
        if not torch.cuda.is_available():
            print("train_grad_witness: --card needs a CUDA GPU",
                  file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(smi)
        _device.set_numerics()
    out = {}
    for arch in args.arch:
        small = cs.small_config(arch)
        for init in ("stacked", "fan-in"):
            start = api.init_params(small, device="cpu", seed=cs.SEED,
                                    hold_bf16=False)
            if init == "fan-in":
                cs.fan_in_scaled(start)
            cpu, cpu_tr, _ = gradient(arch, start, "cpu", trace=args.card)
            wide, _, _ = gradient(arch, start, "cpu", f64=True)
            res = dict(witness=compare(wide, cpu))
            print(f"{arch} {init}: f64 against f32 product sums on the CPU "
                  f"{res['witness']}")
            if args.card:
                card, card_tr, local = gradient(arch, start, "cuda",
                                                trace=True)
                res["card"] = dict(compare(card, cpu), local=local)
                rows = layer_by_layer(card_tr, cpu_tr)
                res["calls"] = rows
                print(f"{arch} {init}: card against CPU {res['card']}")
                for i, shape, fwd, own, dy in rows:
                    print(f"  call {i:3d} w {shape}: output {fwd:.3g} "
                          f"(own {own:.3g}), dY "
                          f"{'-' if dy is None else f'{dy:.3g}'}")
            out[f"{arch} {init}"] = res
    doc = dict(device=smi, result=out)
    if args.out:
        Path(args.out).write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
