"""The row norm against its parent build: bitwise, and timed in turns.

    python3 tools/norm_parent_bits.py [--parent FILE] [--rev REV]
                                      [--rounds N] [--sweep] [--out FILE]

``src/repro_torch/csrc/row_norm.cu`` sums each row in one order set by d
alone, so a rewrite of how the kernel walks that order must give the
parent's bits. This builds the parent's source (``--parent``, default
``build/norm_parent/row_norm.cu``; when that file is missing and the
checkout is a git repository, ``git show REV:...``, default ``HEAD~1``,
writes it) into ``build/norm_parent/`` and calls it through its C entry
point beside ``row_norm_cuda`` on every served width (384, 512, 1024,
1536, 2048, 3072, 4096, 5120), on 8192 and on two widths that are no
multiple of 4 (scalar loads), bf16 and f32 rows, RMS and layer norm, at
M = 1, 8, 40, 256 and 2048. Each case is checked through
``row_norm_cuda`` (the route the plan picks) and, through the C entry
``repro_row_norm_ex`` (``forced_norm``), on every other route and rows
per CTA the kernel takes at that width. Then it times both at [8, d]
and [2048, d] for d = 1024 and 5120, bf16 and f32, RMS and layer norm
(``torch.profiler`` device time, L2 flushed, ``--rounds`` rounds of
parent / current / current / parent, each reading the mean of 20 calls:
the median of each side's readings and their range) beside
``F.rms_norm`` / ``F.layer_norm``, and with ``--sweep`` every route and
rows per CTA at five widths. Prints one line per width and timed row,
then one JSON object (also written to ``--out``); exits 1 if any row
differs.

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX or the reference.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = "src/repro_torch/csrc/row_norm.cu"
WIDTHS = (384, 512, 1024, 1536, 2048, 3072, 4096, 5120, 8192, 1002, 5118)
ROWS = (1, 8, 40, 256, 2048)
TIMED_WIDTHS = (1024, 5120)
TIMED_ROWS = (8, 2048)
SWEEP_WIDTHS = (1024, 1536, 2048, 5120, 8192)
RMS_EPS, LAYER_EPS = 1e-6, 1e-5


def parent_source(path: Path, rev: str) -> Path:
    """``path``, written from ``git show rev:SOURCE`` if it is missing."""
    if not path.exists():
        text = subprocess.run(["git", "show", f"{rev}:{SOURCE}"], cwd=ROOT,
                              capture_output=True, text=True,
                              check=True).stdout
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return path


def build_parent(src: Path):
    from repro_torch.kernels import _build
    lib = src.with_name("librow_norm_parent.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).repro_row_norm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def forced_norm(x, w, b, eps, route=None, rows=0):
    """The current kernel through its C entry ``repro_row_norm_ex`` on a
    forced ``route`` ("narrow" / "wide", None: the plan's) and ``rows``
    per CTA (0: the route's default): x [M, d] bf16 / f32 contiguous, w
    (and b) [d] f32, all on the card and 16-byte aligned."""
    import torch
    from repro_torch.kernels import row_norm as rn
    lib = rn._lib()
    fn = lib.repro_row_norm_ex
    fn.argtypes = lib.repro_row_norm.argtypes[:-1] + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
             None if b is None else b.data_ptr(), out.data_ptr(),
             x.shape[0], x.shape[1], eps,
             0 if route is None else rn.ROUTES[route], rows,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"row_norm ({route}, {rows} rows): "
                           + lib.repro_error_string(err).decode())
    return out


def variants(d: int) -> list[dict]:
    """Every (route, rows) the kernel takes at width d (the limits
    ``plan`` reads from the library), the plan's first as {}."""
    from repro_torch.kernels import row_norm as rn
    p = rn.plan(d)
    out = [{}]
    for route in ("narrow", "wide"):
        out += [{"route": route, "rows": r}
                for r in (1, 2, 4, 8, 15) if r <= p["max_rows"][route]
                and not (route == p["route"] and r == p["rows"])]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path,
                    default=ROOT / "build" / "norm_parent" / "row_norm.cu")
    ap.add_argument("--rev", default="HEAD~1")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from repro_torch.kernels import row_norm as rn
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    parent = build_parent(parent_source(args.parent, args.rev))
    rn.plan(1024)                               # builds the current kernel
    from repro_torch.kernels import _build
    for line in _build.BUILD_LOG.get("row_norm", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[norm-parent] ptxas: {line.strip()}", flush=True)

    def parent_norm(x, w, b, eps):
        out = torch.empty_like(x)
        err = parent(x.data_ptr(), int(x.dtype == torch.bfloat16),
                     w.data_ptr(), None if b is None else b.data_ptr(),
                     out.data_ptr(), x.shape[0], x.shape[1], eps,
                     torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"the parent norm's launch failed: {err}")
        return out

    g = torch.Generator(device=dev).manual_seed(27)
    same_all, n_cases, differing = True, 0, []
    plans = {}
    for d in WIDTHS:
        plans[d] = rn.plan(d)
        forms = variants(d)
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b = chip_smoke.norm_inputs(g, dev, max(ROWS), d, dtype)
            for kind, eps, bias in (("rms", RMS_EPS, None),
                                    ("layer", LAYER_EPS, b)):
                for m in ROWS:
                    want = parent_norm(x[:m], w, bias, eps)
                    for form in forms:
                        got = (forced_norm(x[:m], w, bias, eps, **form)
                               if form else rn.row_norm_cuda(
                                   x[:m], w, bias, eps=eps))
                        n_cases += 1
                        if not torch.equal(got, want):
                            same_all = False
                            differing.append(dict(d=d, dtype=str(dtype)[6:],
                                                  kind=kind, m=m, **form))
            del x
        print(f"[norm-parent] d={d} plan {plans[d]}: {len(forms)} routes x "
              f"bf16 / f32 x rms / layer x M = {ROWS}; differing so far "
              f"{len(differing)}", flush=True)
    torch.cuda.synchronize()
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)

    def timed(run, what):
        return chip_smoke.kernel_ms(run, flush, ("row_norm",), what=what)

    times = {}
    for d in TIMED_WIDTHS:
        for m in TIMED_ROWS:
            for dtype in (torch.bfloat16, torch.float32):
                x, w, b = chip_smoke.norm_inputs(g, dev, m, d, dtype)
                for kind in ("rms", "layer"):
                    bias = b if kind == "layer" else None
                    eps = LAYER_EPS if bias is not None else RMS_EPS
                    runs = {"parent": lambda: parent_norm(x, w, bias, eps),
                            "current": lambda: rn.row_norm_cuda(
                                x, w, bias, eps=eps)}
                    key = f"{kind} {str(dtype)[6:]} [{m}, {d}]"
                    got = {k: [] for k in runs}
                    for _ in range(args.rounds):
                        for name in ("parent", "current", "current",
                                     "parent"):
                            got[name].append(timed(runs[name],
                                                   f"{key} {name}"))
                    wl = w.to(dtype)
                    lib = ((lambda: F.layer_norm(x, (d,), wl, b.to(dtype),
                                                 eps=eps)) if bias is not None
                           else (lambda: F.rms_norm(x, (d,), wl, eps=eps)))
                    row = {k: statistics.median(v) for k, v in got.items()}
                    row.update({f"{k}_range": [min(v), max(v)]
                                for k, v in got.items()})
                    row["readings"] = got
                    row["library"] = chip_smoke.kernel_ms(lib, flush,
                                                          what=f"{key} lib")
                    row["bound"] = rn.bytes_moved(
                        m, d, x.element_size(), bias is not None) \
                        / chip_smoke.HBM_BYTES_PER_S * 1e3
                    times[key] = row
                    print(f"[norm-parent] {key}: median of "
                          f"{2 * args.rounds} (range) parent "
                          f"{row['parent']:.4f} ms ({row['parent_range'][0]:.4f}"
                          f"-{row['parent_range'][1]:.4f}), current "
                          f"{row['current']:.4f} ms "
                          f"({row['current_range'][0]:.4f}"
                          f"-{row['current_range'][1]:.4f}), library "
                          f"{row['library']:.4f} ms, bound "
                          f"{row['bound']:.4f} ms", flush=True)
    sweep = {}
    if args.sweep:
        for d in SWEEP_WIDTHS:
            for m in TIMED_ROWS:
                for dtype in (torch.bfloat16, torch.float32):
                    x, w, b = chip_smoke.norm_inputs(g, dev, m, d, dtype)
                    for kind, bias in (("rms", None), ("layer", b)):
                        eps = RMS_EPS if bias is None else LAYER_EPS
                        for form in variants(d):
                            label = (f"{kind} {str(dtype)[6:]} [{m}, {d}] "
                                     f"{form.get('route', 'plan')} "
                                     f"{form.get('rows', '')}").strip()
                            sweep[label] = timed(
                                lambda: forced_norm(x, w, bias, eps,
                                                    **form), label)
                            print(f"[norm-parent] sweep {label}: "
                                  f"{sweep[label]:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"bitwise": same_all, "cases": n_cases,
              "differing": differing[:20], "plans": plans, "ms": times,
              "sweep": sweep, "device": smi}
    print(json.dumps(result))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
