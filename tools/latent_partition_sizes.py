"""The latent (MLA) paged-attention kernel (B3) at three partition sizes.

    python3 tools/latent_partition_sizes.py [SLOTS ...]

``src/repro_torch/csrc/paged_latent_attention.cu`` splits each sequence's
block table into fixed partitions of ``kSlots`` slots (one CTA per
partition and 64 query rows) and merges them in a second kernel. Each
SLOTS (default 4 8 16) is a copy of the source with that ``kSlots``,
compiled into ``build/latent_slots/`` and called through its C entry
point at the times phase's shape of ``chip_smoke.py``
(deepseek-v2 decode: B = 8, W = 1, H = 128, C = 512, R = 64, bs = 16,
64-slot tables, 2304 live tokens, bf16 pools). Per variant it prints the
largest difference from the plain twin, the live partitions, and the
device time of split + merge (``torch.profiler``, L2 flushed, as the times
phase reads it), the variants in turns, three rounds.

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX or the reference.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


LINE = "constexpr int kSlots = 4;"


def build(sizes):
    from repro_torch.kernels import _build
    out = ROOT / "build" / "latent_slots"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "paged_latent_attention.cu").read_text()
    if text.count(LINE) != 1:
        raise SystemExit(f"paged_latent_attention.cu no longer holds "
                         f"{LINE!r}")
    procs = {}
    for s in sizes:
        src = out / f"paged_latent_attention_s{s}.cu"
        src.write_text(text.replace(LINE, f"constexpr int kSlots = {s};"))
        lib = out / f"libpaged_latent_attention_s{s}.so"
        procs[s] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for s, (path, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for SLOTS={s}:\n{text}")
        lib = ctypes.CDLL(str(path))
        lib.repro_paged_latent_attention.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.repro_paged_latent_attention.restype = ctypes.c_int
        lib.repro_paged_latent_attention_scratch.argtypes = [ctypes.c_int] * 4
        lib.repro_paged_latent_attention_scratch.restype = ctypes.c_longlong
        fns[s] = lib
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import device
    from repro_torch.kernels import paged_attention as pa
    device.set_numerics()
    sizes = [int(a) for a in sys.argv[1:]] or [4, 8, 16]
    fns = build(sizes)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[slots] {torch.cuda.get_device_name(0)}; {smi}")
    x = cs.latent_case(dev, mb=64, lens=[544, 65, 300, 400, 97, 512, 130,
                                         256])
    args, kw = cs._latent_args(x)
    want = pa.paged_latent_attention_plain(*args, **kw)
    b, w, h, c = x["q_lat"].shape
    r, bs, mb = x["q_rope"].shape[-1], x["ck_pool"].shape[1], 64

    def runner(s, lib):
        out = torch.empty_like(want)
        part = torch.empty(lib.repro_paged_latent_attention_scratch(
            b, w * h, c, mb), device=dev)

        def run():
            err = lib.repro_paged_latent_attention(x["q_lat"].data_ptr(), x["q_rope"].data_ptr(),
                     x["ck_pool"].data_ptr(), x["kr_pool"].data_ptr(), None,
                     None, x["block_table"].data_ptr(), x["lens"].data_ptr(),
                     x["q_offsets"].data_ptr(), out.data_ptr(),
                     part.data_ptr(), b, w, h, c, r, bs, mb,
                     float(x["scale"]), 0, 1, 0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"SLOTS={s}: launch failed ({err})")
            return out
        return run

    runs = {s: runner(s, lib) for s, lib in fns.items()}
    for s, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        live = sum(-(-min(mb, -(-int(n) // bs)) // s) for n in x["lens"])
        print(f"[slots] SLOTS={s}: {live} live partitions x 2 row tiles; "
              f"max|kernel-plain| {float((got - want).abs().max()):.3g}")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    names = ("paged_latent_attention_split_kernel",
             "paged_latent_attention_merge_kernel")
    times = {s: [] for s in runs}
    for _ in range(3):
        for s, run in runs.items():
            times[s].append(cs.kernel_ms(run, flush, names,
                                         what=f"SLOTS={s}"))
    for s, t in times.items():
        print(f"[slots] SLOTS={s}: split + merge "
              f"{', '.join(f'{v:.4f}' for v in t)} ms (profiler device "
              f"time, L2 flushed, three rounds)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
