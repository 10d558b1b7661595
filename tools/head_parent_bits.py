"""The serving head against its parent build: bitwise, and timed in turns.

    python3 tools/head_parent_bits.py [--parent FILE] [--rev REV]

``src/repro_torch/csrc/serving_head.cu`` computes every logit as one fmaf
chain in k order, so a rewrite of how the kernel reaches that chain must
give the parent's bits. This builds the parent's source (``--parent``,
default ``build/head_parent/serving_head.cu``; when that file is missing
and the checkout is a git repository, ``git show REV:...``, default
``HEAD~1``, writes it) into ``build/head_parent/`` and calls it through
its C entry point beside ``serving_head_cuda``, on every case of
``chip_smoke.HEAD_CASES`` (qwen1.5-0.5b's head, mamba2-780m's, the tied
embedding) and on a [384, 51865] head (whisper-tiny's widths as an
untied [K, V]: V no multiple of 4, the 4-byte staging), at M = 1, 8, 40
and 64, for bf16 and f32 hidden states. Then it times both at M = 8, 16,
24, 40 and 64 on qwen1.5's head (CUDA events, L2 flushed, median of 25,
parent and current in turns). Prints one line per case, then one JSON
object; exits 1 if any row differs.

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

SOURCE = "src/repro_torch/csrc/serving_head.cu"
ROWS = (1, 8, 40, 64)
TIMED = (8, 16, 24, 40, 64)
EXTRA = (("whisper-tiny widths, untied [K, V]", 384, 51865, False),)


def parent_source(path: Path, rev: str, source: str = SOURCE) -> Path:
    """``path``, written from ``git show rev:source`` if it is missing."""
    if not path.exists():
        text = subprocess.run(["git", "show", f"{rev}:{source}"], cwd=ROOT,
                              capture_output=True, text=True,
                              check=True).stdout
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return path


def build_parent(src: Path):
    from repro_torch.kernels import _build
    lib = src.with_name("libserving_head_parent.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    fn = dll.repro_serving_head
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path,
                    default=ROOT / "build" / "head_parent" / "serving_head.cu")
    ap.add_argument("--rev", default="HEAD~1")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke
    from repro_torch.kernels import serving_head as sh
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    parent = build_parent(parent_source(args.parent, args.rev))

    def parent_head(h, w, tied):
        d = h.shape[-1]
        v = w.shape[0] if tied else w.shape[1]
        out = torch.empty((h.shape[0], v), dtype=torch.float32, device=dev)
        err = parent(h.data_ptr(), int(h.dtype == torch.bfloat16),
                     w.data_ptr(), int(tied), out.data_ptr(), h.shape[0], d,
                     v, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"the parent head's launch failed: {err}")
        return out

    g = torch.Generator(device=dev).manual_seed(26)
    cases, same_all = [], True
    for label, d, v, tied in chip_smoke.HEAD_CASES + EXTRA:
        w = torch.randn((v, d) if tied else (d, v), generator=g,
                        device=dev) / math.sqrt(d)
        for hdt in (torch.bfloat16, torch.float32):
            h = torch.randn((max(ROWS), d), generator=g, device=dev).to(hdt)
            for m in ROWS:
                same = torch.equal(sh.serving_head_cuda(h[:m], w, tied=tied),
                                   parent_head(h[:m], w, tied))
                same_all = same_all and same
                cases.append(dict(case=label, h=str(hdt)[6:], m=m,
                                  bitwise=same))
                print(f"[head-parent] {label} {str(hdt)[6:]} h, M = {m}: "
                      f"bitwise the parent's {same}", flush=True)
        del w
    torch.cuda.synchronize()
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    d, v = 1024, 151936
    w = torch.randn((d, v), generator=g, device=dev) / math.sqrt(d)
    times = {}
    for m in TIMED:
        h = torch.randn((m, d), generator=g, device=dev).to(torch.bfloat16)
        runs = {"parent": lambda: parent_head(h, w, False),
                "current": lambda: sh.serving_head_cuda(h, w)}
        got = {k: [] for k in runs}
        for name in ("parent", "current", "current", "parent"):
            got[name].append(chip_smoke.time_ms(runs[name], flush))
        times[m] = {k: min(x) for k, x in got.items()}
        print(f"[head-parent] qwen1.5-0.5b head M = {m}: parent "
              f"{times[m]['parent']:.4f} ms, current "
              f"{times[m]['current']:.4f} ms (CUDA events, median of 25, "
              f"better of two turns)", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"bitwise": same_all, "cases": len(cases),
                      "ms": times, "device": smi}))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
