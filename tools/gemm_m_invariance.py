"""Do the served path's bf16 GEMM rows keep their bits across M on the
card, and what does a form fixed for every M cost?

    python3 tools/gemm_m_invariance.py [--out PATH]

The dense products of qwen1.5-0.5b (per layer: q, k, v and o, [1024 x
1024]; gate_up [1024 x 5632]; down [2816 x 1024]) run as bf16 x bf16
GEMMs with an f32 result, ``torch.mm(..., out_dtype=torch.float32)``,
the form ``repro_torch.models.common.dense`` takes on the card. The
engine calls them at M = 8 (a decode step's slots), 40 (a verify step's
8 x 5 rows) and up to 256 (a prefill chunk). cuBLAS picks its kernel by
M, so a row's bits can depend on the rows it was computed beside. For
each M in 8, 40, 240 this script compares the first 8 rows of each
product with the same rows computed at M = 8:

- ``library``: cuBLAS's own choice at each M;
- ``fixed``: every call padded with zero rows to ``M_FIX`` = 256 (one
  call per 256 rows), so one call shape, and one kernel, serves every M.

The f32 LM head ([1024 x 151936], TF32 off) is compared the same way for
context: it is not a bf16 product. Then it times the 144 products of one
qwen1.5 decode step (24 layers of weights, so the L2 holds none of
them, as in the engine) at M = 8 by CUDA events, median of 20: in the
library form, in the fixed form (the pad included), and in the form the
port ran before its weights were held as bf16 (bf16-rounded operands
widened to f32 on every call, f32 GEMMs). Prints one JSON object as the
last line (and writes it to ``--out``); exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

M_FIX = 256
MS = (8, 40, 240)
D, FF, LAYERS, VOCAB = 1024, 2816, 24, 151936
SHAPES = {"q": (D, D), "k": (D, D), "v": (D, D), "o": (D, D),
          "gate_up": (D, 2 * FF), "down": (FF, D)}


def mm(x, w):
    import torch
    return torch.mm(x, w, out_dtype=torch.float32)


def mm_fixed(x, w):
    """``mm`` on rows padded with zeros to whole calls of M_FIX rows."""
    import torch
    m = x.shape[0]
    pad = -m % M_FIX
    if pad:
        x = torch.cat([x, x.new_zeros(pad, x.shape[1])])
    return torch.cat([mm(x[i:i + M_FIX], w)
                      for i in range(0, m + pad, M_FIX)])[:m]


def row_bits(fn, x, w) -> dict:
    """The first 8 rows at each M against the same rows at M = 8."""
    import torch
    base = fn(x[:8], w)
    out = {}
    for m in MS:
        rows = fn(x[:m], w)[:8]
        diff = (rows != base)
        out[str(m)] = {"rows_differ": int(diff.any(dim=1).sum()),
                       "elems_differ": int(diff.sum()),
                       "max_abs": float((rows - base).abs().max())}
    torch.cuda.synchronize()
    return out


def events_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gemm_m_invariance: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.strip(),
           "torch": torch.__version__, "cuda": torch.version.cuda}

    # the ops C1 needs: bf16 operands, f32 result
    a = torch.randn(8, D, generator=g, device=dev).bfloat16()
    b = torch.randn(D, D, generator=g, device=dev).bfloat16()
    ops = {}
    for name, call in (("mm.dtype", lambda: mm(a, b)),
                       ("bmm.dtype", lambda: torch.bmm(
                           a[None], b[None], out_dtype=torch.float32))):
        try:
            y = call()
            want = a.float() @ b.float()
            ops[name] = {"ok": True, "dtype": str(y.dtype),
                         "max_abs_vs_widened": float((y - want).abs().max())}
        except Exception as e:                      # noqa: BLE001
            ops[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    res["ops"] = ops
    print(json.dumps({"ops": ops}), flush=True)
    if not ops["mm.dtype"]["ok"]:
        print(json.dumps(res))
        return 1

    x = torch.randn(max(MS), FF, generator=g, device=dev)
    inv = {}
    for name, (k, n) in SHAPES.items():
        w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).bfloat16()
        xb = x[:, :k].bfloat16()
        inv[name] = {"library": row_bits(mm, xb, w),
                     "fixed": row_bits(mm_fixed, xb, w)}
    head = torch.randn(D, VOCAB, generator=g, device=dev) / D ** 0.5
    inv["lm_head_f32"] = {"library": row_bits(
        lambda u, v: u @ v, x[:, :D].contiguous(), head)}
    del head
    res["row_bits"] = inv
    res["library_bitwise_across_M"] = all(
        c["rows_differ"] == 0 for nm, f in inv.items() if nm != "lm_head_f32"
        for c in f["library"].values())
    res["fixed_bitwise_across_M"] = all(
        c["rows_differ"] == 0 for nm, f in inv.items() if "fixed" in f
        for c in f["fixed"].values())

    # one decode step's 144 products, weights cold in L2 (24 layers)
    ws = [{nm: (torch.randn(k, n, generator=g, device=dev)
                / k ** 0.5).bfloat16() for nm, (k, n) in SHAPES.items()}
          for _ in range(LAYERS)]
    wf = [{nm: w.float() for nm, w in lw.items()} for lw in ws]
    x8 = {nm: x[:8, :k].bfloat16() for nm, (k, _) in SHAPES.items()}

    def step(fn, weights, xs):
        def run():
            for lw in weights:
                for nm, w in lw.items():
                    fn(xs[nm], w)
        return run

    def widened(u, w):
        return u.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()

    x8f = {nm: v.float() for nm, v in x8.items()}
    times = {}
    for rnd in range(2):                 # library, fixed, widened, in turns
        for form, run in (("library", step(mm, ws, x8)),
                          ("fixed", step(mm_fixed, ws, x8)),
                          ("widened_f32", step(widened, wf, x8f))):
            times.setdefault(form, []).append(events_ms(run))
    res["decode_gemms_ms"] = {k: v for k, v in times.items()}
    lib = statistics.mean(times["library"])
    fix = statistics.mean(times["fixed"])
    res["fixed_minus_library_ms"] = fix - lib
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
