"""Route T of the compensated matmul (B5 / B6), one variant per hi.hi
run length: accuracy on the ill-conditioned deep contraction and time.

    python3 tools/kahan_hi_run.py [RUN ...]

Route T of ``src/repro_torch/csrc/kahan_matmul.cu`` feeds f32 operands to
the bf16 tensor cores as exact planes; the largest product, hi.hi, takes
a fresh tensor-core accumulator at every k16 step and joins the block's
sum round-to-nearest. A run of RUN steps instead chains hi.hi in the
tensor core (whose adds do not round to nearest) for RUN k16 steps before
it joins the sum. Each RUN (default 1 2 4 and ``block``, the whole bk
block: the chain before the repair) is a copy of the source patched with
that run length (``PATCH``; RUN 1 is the shipped arithmetic), compiled
into ``build/hi_run/`` and called through its C entry point. Per variant
it prints:

* the max |C - exact| of ``kahan_matmul.deep_case(72)`` (K = 2^14, bk =
  128; route T) beside the reference's own error on the same inputs
  (``kahan_matmul.DEEP_CASE_REFERENCE_ERR``) and a naive f32 matmul's;
  the same for its B quantized to int8 and to fp8 per 128-row block
  (f32 x 8-bit, three plane products), against
  ``kahan_matmul.DEEP_CASE_Q8_REFERENCE_ERR`` and ``A @ dequant(B)`` in
  f32;
* the device time (CUDA events, L2 flushed, median of 25) of B5 f32 and
  B6 int8 at the qwen1.5-0.5b down projection ([2048, 2816] x [2816,
  1024], bk 256), variants in turns.

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX or the reference.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


# (shipped text, replacement): hi.hi chained for kHiRun steps; rib counts
# the steps of the open run, and a run that the stage's last step ended
# joins the sum when the stage's products are done
PATCH = (
    ("constexpr int kSM = 8;",
     "constexpr int kSM = 8;\nconstexpr int kHiRun = RUN;"),
    ("int step = 0, blk = 0, sib = 0;",
     "int step = 0, blk = 0, sib = 0, rib = 0;"),
    ("kTwoAcc ? 0 : acc);", "kTwoAcc ? rib != 0 : acc);"),
    ("        if (blk_end) sib = 0;\n        if (kTwoAcc || blk_end) {",
     "        const bool run_end = kTwoAcc && (blk_end || ++rib == kHiRun);\n"
     "        if (blk_end) sib = 0;\n        if (run_end) rib = 0;\n"
     "        if (run_end || blk_end) {"),
    ("            if (kTwoAcc) add_hi();\n            if (blk_end) fold(blk);",
     "            if (run_end) add_hi();\n            if (blk_end) fold(blk);"),
    ("    if (kTwoAcc) add_hi();\n    if (pending >= 0) fold(pending);",
     "    if (kTwoAcc && rib == 0) add_hi();\n"
     "    if (pending >= 0) fold(pending);"),
)


def patched(text: str, run: int) -> str:
    for old, new in PATCH:
        if text.count(old) != 1:
            raise SystemExit(f"kahan_matmul.cu no longer holds {old!r}")
        text = text.replace(old, new.replace("RUN", str(run)))
    return text


def build(runs):
    from repro_torch.kernels import _build
    out = ROOT / "build" / "hi_run"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "kahan_matmul.cu").read_text()
    procs = {}
    for run in runs:
        src = out / f"kahan_matmul_hi{run}.cu"
        src.write_text(patched(text, 1 << 20 if run == "block" else int(run)))
        lib = out / f"libkahan_matmul_hi{run}.so"
        procs[run] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for run, (path, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for RUN={run}:\n{text}")
        lib = ctypes.CDLL(str(path))
        fn = lib.repro_kahan_matmul_tile
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[run] = fn
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    import importlib
    from repro_torch import device
    km = importlib.import_module("repro_torch.kernels.kahan_matmul")
    from repro_torch.quant import core as qcore
    device.set_numerics()
    runs = sys.argv[1:] or ["1", "2", "4", "block"]
    libs = build(runs)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[hi_run] {torch.cuda.get_device_name(0)}; {smi}")

    def call(fn, a, b, s=None, bk=128, b_type=1):
        out = torch.empty((a.shape[0], b.shape[1]), device=dev)
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if s is None else s.data_ptr(), out.data_ptr(),
                 a.shape[0], b.shape[1], a.shape[1], bk,
                 1 if a.dtype == torch.float32 else 0, b_type,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: {err}")
        return out

    a_np, b_np = km.deep_case(72)
    a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)
    exact = np.float64(a_np) @ np.float64(b_np)
    naive = float(np.abs((a @ b).double().cpu().numpy() - exact).max())
    ref = km.DEEP_CASE_REFERENCE_ERR[72]
    for run, fn in libs.items():
        got = call(fn, a, b).double().cpu().numpy()
        err = float(np.abs(got - exact).max())
        print(f"[hi_run] RUN={run}: deep M=72 K=2^14 bk=128 max|C-exact| "
              f"{err:.4f} = {err / ref:.2f}x the reference's {ref:.4f}; "
              f"naive f32 {naive:.4f}")
    for fmt, code in (("int8", 2), ("fp8", 3)):
        qw, qs = qcore.quantize_weight(torch.from_numpy(b_np),
                                       qcore.get_format(fmt), block_k=128)
        deq = qcore.dequantize_weight(qw, qs)
        exact = np.float64(a_np) @ deq.double().numpy()
        qw, qs, deq = qw.to(dev), qs.to(dev), deq.to(dev)
        naive = float(np.abs((a @ deq).double().cpu().numpy() - exact).max())
        ref = km.DEEP_CASE_Q8_REFERENCE_ERR[(fmt, 72)]
        for run, fn in libs.items():
            got = call(fn, a, qw, qs, b_type=code).double().cpu().numpy()
            err = float(np.abs(got - exact).max())
            print(f"[hi_run] RUN={run}: deep M=72 K=2^14 bk=128 f32 x {fmt} "
                  f"max|C-exact| {err:.4f} = {err / ref:.2f}x the "
                  f"reference's {ref:.4f}; naive f32 {naive:.4f}")

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2048, 2816), generator=g, device=dev)
    w = torch.randn((2816, 1024), generator=g, device=dev) * 0.02
    qw, qs = qcore.quantize_weight(w, qcore.INT8, block_k=256)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    cases = {"B5 f32": lambda fn: call(fn, x, w, bk=256),
             "B6 int8": lambda fn: call(fn, x, qw, qs, bk=256, b_type=2)}
    times = {(c, r): [] for c in cases for r in libs}
    for _ in range(3):                   # variants in turns
        for r, fn in libs.items():
            for c, run in cases.items():
                run(fn)
                torch.cuda.synchronize()
                ev = []
                for _ in range(25):
                    flush.zero_()
                    s0 = torch.cuda.Event(enable_timing=True)
                    e0 = torch.cuda.Event(enable_timing=True)
                    s0.record()
                    run(fn)
                    e0.record()
                    ev.append((s0, e0))
                torch.cuda.synchronize()
                times[(c, r)].append(statistics.median(
                    s0.elapsed_time(e0) for s0, e0 in ev))
    for (c, r), t in times.items():
        print(f"[hi_run] RUN={r}: {c} [2048, 2816] x [2816, 1024] bk 256: "
              f"{', '.join(f'{v:.4f}' for v in t)} ms (CUDA-event medians, "
              f"three turns)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
