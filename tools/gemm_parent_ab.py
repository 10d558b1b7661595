"""The M-invariant bf16 product against its parent build: bits and the
device time of one qwen1.5 decode step's products, in turns.

    python3 tools/gemm_parent_ab.py [--parent FILE] [--rev REV] [--out PATH]

Builds the parent's ``src/repro_torch/csrc/invariant_gemm.cu``
(``--parent``, default ``build/gemm_parent/invariant_gemm.cu``; when that
file is missing and the checkout is a git repository, ``git show
REV:...``, default ``HEAD~1``, writes it) into ``build/gemm_parent/``
and calls it through its C entry point with its own K split
(``parent_plan``: 64 x 64 tiles, K chunks of 32, at most 32 parts, a
second fold kernel), beside ``invariant_gemm_cuda``. At qwen1.5-0.5b's
product shapes (q/k/v/o [1024 x 1024], gate_up [1024 x 5632], down [2816
x 1024]) and M = 8, 40 and 256 it reports whether the two give the same
bits and how far apart they are, in units of sqrt(K) 2^-24 sum|x w|.
Then it runs the 144 products of one decode step (24 layers of weights,
M = 8, L2 flushed first) under ``torch.profiler``: device busy ms and
kernels per step of the parent, the current kernel and cuBLAS
(``torch.mm`` with an f32 result), in turns (parent, current, cuBLAS,
cuBLAS, current, parent). Last, each shape on both of the kernel's
routes, forced, at M = 64 to 512 (profiler device time, in turns):
where the route boundary should lie.
Prints the card's name and power limit first and one JSON object as the
last line (also written to ``--out``); exits non-zero without a card.

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX or the reference.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = "src/repro_torch/csrc/invariant_gemm.cu"
SHAPES = {"q/k/v/o": (1024, 1024), "gate_up": (1024, 5632),
          "down": (2816, 1024)}
DECODE = ("q/k/v/o",) * 4 + ("gate_up", "down")    # one layer's products
LAYERS, ROWS = 24, (8, 40, 256)
ROUTE_ROWS = (64, 128, 192, 256, 512)


def parent_plan(batch: int, k: int, n: int) -> tuple[int, int]:
    """The parent's ``split_plan``: BN 64, BK 32, 132 CTAs, 32 parts."""
    tiles = batch * -(-n // 64)
    kc = -(-k // 32)
    want = min(kc, 32, max(1, -(-132 // tiles)))
    cps = -(-kc // want)
    return -(-kc // cps), cps


def build_parent(src: Path):
    from repro_torch.kernels import _build
    lib = src.with_name("libinvariant_gemm_parent.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).repro_invariant_gemm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=ROOT / "build"
                    / "gemm_parent" / "invariant_gemm.cu")
    ap.add_argument("--rev", default="HEAD~1")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from head_parent_bits import parent_source
    from repro_torch.kernels import invariant_gemm as ig
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    parent = build_parent(parent_source(args.parent, args.rev, SOURCE))

    def parent_mm(x, w):
        m, k = x.shape
        n = w.shape[1]
        splits, cps = parent_plan(1, k, n)
        y = torch.empty((m, n), dtype=torch.float32, device=dev)
        scratch = (torch.empty((splits, m, n), dtype=torch.float32,
                               device=dev) if splits > 1 else None)
        err = parent(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                     None if scratch is None else scratch.data_ptr(), 1, m,
                     n, k, splits, cps, 1,
                     torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"the parent product's launch failed: {err}")
        return y

    g = torch.Generator(device=dev).manual_seed(26)
    res = {"device": smi, "bits": {}}
    for label, (k, n) in SHAPES.items():
        w = (torch.randn((k, n), generator=g, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        x = torch.randn((max(ROWS), k), generator=g, device=dev).to(
            torch.bfloat16)
        for m in ROWS:
            old, new = parent_mm(x[:m], w), ig.invariant_gemm_cuda(x[:m], w)
            scale = ig.invariant_gemm_plain(x[:m].abs(), w.abs()) * (
                math.sqrt(k) * 2.0 ** -24)
            diff = (old - new).abs()
            row = {"bitwise": bool(torch.equal(old, new)),
                   "differing": float((diff > 0).float().mean()),
                   "max_units": float((diff / scale).max()),
                   "parent_plan": parent_plan(1, k, n),
                   "plan": ig.split_plan(1, k, n)}
            res["bits"][f"{label} M={m}"] = row
            print(f"[gemm-parent] {label} M = {m}: {row}", flush=True)
    # one decode step's 144 products, 24 layers of weights
    ws = [{s: (torch.randn(SHAPES[s], generator=g, device=dev)
               / math.sqrt(SHAPES[s][0])).to(torch.bfloat16)
           for s in SHAPES} for _ in range(LAYERS)]
    xs = {s: torch.randn((8, SHAPES[s][0]), generator=g, device=dev).to(
        torch.bfloat16) for s in SHAPES}
    forms = {
        "parent": lambda: [parent_mm(xs[s], lw[s]) for lw in ws
                           for s in DECODE],
        "current": lambda: [ig.invariant_gemm_cuda(xs[s], lw[s])
                            for lw in ws for s in DECODE],
        "cublas": lambda: [torch.mm(xs[s], lw[s], out_dtype=torch.float32)
                           for lw in ws for s in DECODE]}
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    got = {k: [] for k in forms}
    for name in ("parent", "current", "cublas", "cublas", "current",
                 "parent"):
        forms[name]()
        torch.cuda.synchronize()
        for _ in range(cs.PROFILE_TRIES):
            flush.zero_()
            window = cs._launches(forms[name], None, 1)
            if window:
                break
        got[name].append({"busy_ms": sum(us for _, us in window.values())
                          / 1e3,
                          "kernels": sum(c for c, _ in window.values())})
    res["decode_products"] = got
    for name, runs in got.items():
        print(f"[gemm-parent] 144 decode products, {name}: "
              + ", ".join(f"{r['busy_ms']:.4f} ms busy, {r['kernels']} "
                          f"kernels" for r in runs), flush=True)
    # where the routes cross: both forced at each M, in turns
    res["routes"] = {}
    for label, (k, n) in SHAPES.items():
        w = ws[0][label]
        for m in ROUTE_ROWS:
            x = torch.randn((m, k), generator=g, device=dev).to(
                torch.bfloat16)
            ms = {r: [] for r in ("skinny", "wide")}
            for r in ("skinny", "wide", "wide", "skinny"):
                ms[r].append(cs.kernel_ms(
                    lambda r=r: ig.invariant_gemm_cuda(x, w, route=r), flush,
                    ("invariant_gemm",), what=f"{label} M={m} {r}"))
            res["routes"][f"{label} M={m}"] = {r: min(v)
                                               for r, v in ms.items()}
            print(f"[gemm-parent] {label} M = {m}: "
                  f"{res['routes'][f'{label} M={m}']} (profiler ms, the "
                  f"better of two turns)", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
