"""B4's ALIGNED builds against the general builds alone, at head dims
whose rows are 16-byte aligned: the reason each flash kernel is built
twice.

    python3 tools/flash_aligned_ab.py

``src/repro_torch/csrc/flash_attention_wgmma.cu`` launches an ALIGNED
build of each kernel (16-byte copies only) when every row of q, k and v
starts 16-byte aligned, and the general build (16-, 8- or 4-byte copies
by the rows' alignment, plain loads for 2-byte rows) otherwise. This
script compiles two copies of the source into ``build/flash_ab/``: the
shipped one, and one patched so that ``all_aligned`` is false (the
general build alone, ``PATCH``). For each it prints the ptxas registers
and the count of C7519 warnings (warpgroup.arrive fences injected around
the products), then, at [64, 2048, D] causal (qwen1.5-0.5b's prefill of
four 2048-token prompts) for D = 64 and 40 in bf16 and f32:

* whether the two builds give the same bits;
* the device time of each (CUDA events, L2 flushed by a 256 MB memset
  before every call, median of 25), in three turns, builds alternating.

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX or the reference.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

PATCH = ("  return wq == 16 && wk == 16 && wv == 16;", "  return false;")


def build() -> dict:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "flash_ab"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "flash_attention_wgmma.cu").read_text()
    if text.count(PATCH[0]) != 1:
        raise SystemExit(f"flash_attention_wgmma.cu no longer holds "
                         f"{PATCH[0]!r}")
    procs = {}
    for variant, src_text in (("aligned", text),
                              ("general", text.replace(*PATCH))):
        src = out / f"flash_attention_wgmma_{variant}.cu"
        src.write_text(src_text)
        lib = out / f"libflash_attention_wgmma_{variant}.so"
        procs[variant] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {variant}:\n{log}")
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                   log)})
        print(f"[flash_ab] {variant} build: registers per kernel {regs}, "
              f"C7519 warnings {log.count('C7519')}")
        lib = ctypes.CDLL(str(path))
        for fn in (lib.repro_flash_attention_wgmma,
                   lib.repro_flash_attention_wgmma_f32):
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        libs[variant] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    from repro_torch import device
    device.set_numerics()
    libs = build()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[flash_ab] {torch.cuda.get_device_name(0)}; {smi}")

    def call(lib, q, k, v):
        fn = (lib.repro_flash_attention_wgmma if q.dtype == torch.bfloat16
              else lib.repro_flash_attention_wgmma_f32)
        bh, l, d = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, l, l, d, d, float(d ** -0.5), 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: {err}")
        return out

    g = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for d in (64, 40):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((64, 2048, d), generator=g,
                                   device=dev).to(dt) for _ in range(3))
            cases[f"[64, 2048, {d}] {str(dt)[6:]}"] = (q, k, v)
    for c, qkv in cases.items():
        same = torch.equal(call(libs["aligned"], *qkv),
                           call(libs["general"], *qkv))
        print(f"[flash_ab] {c} causal: the two builds bitwise equal {same}")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    times = {(c, b): [] for c in cases for b in libs}
    for _ in range(3):                   # builds in turns
        for b, lib in libs.items():
            for c, qkv in cases.items():
                call(lib, *qkv)
                torch.cuda.synchronize()
                ev = []
                for _ in range(25):
                    flush.zero_()
                    s0 = torch.cuda.Event(enable_timing=True)
                    e0 = torch.cuda.Event(enable_timing=True)
                    s0.record()
                    call(lib, *qkv)
                    e0.record()
                    ev.append((s0, e0))
                torch.cuda.synchronize()
                times[(c, b)].append(statistics.median(
                    s0.elapsed_time(e0) for s0, e0 in ev))
    for c in cases:
        a, g_ = times[(c, "aligned")], times[(c, "general")]
        print(f"[flash_ab] {c} causal: aligned "
              f"{', '.join(f'{t:.4f}' for t in a)} ms, general "
              f"{', '.join(f'{t:.4f}' for t in g_)} ms (CUDA-event medians, "
              f"three turns; general / aligned "
              f"{statistics.median(g_) / statistics.median(a):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
