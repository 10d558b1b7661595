"""The one-launch reduction kernel (B2 / B2f) at several split lengths.

    python3 tools/reduce_split_sizes.py [SEG ...]

``src/repro_torch/csrc/fused_reduce.cu`` cuts each row into splits of
``seg`` elements, one CTA each, and the last CTA of a row folds the
row's partials; ``kernels/engine.py::splits`` sets ``seg`` from N alone.
This tool calls the library's C entry point with each SEG (default 2048
4096 8192 16384 32768 65536) at the shapes ``chip_smoke.py`` checks: the
four (rows, vocab) shapes of ``REDUCE_SHAPES`` with the decode step's
(max, sum, sumsq), and one dot of 2^24 pairs, compensated and naive.
Per SEG and shape it prints the device time per call (``torch.profiler``,
L2 flushed, as the times phase reads it), the SEG values in turns, three
rounds, the largest difference from the plain twin's compensated sum,
and the split length that ``splits`` picks.

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX or the reference.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import device
    from repro_torch.kernels import engine
    device.set_numerics()
    segs = [int(a) for a in sys.argv[1:]] or [2048, 4096, 8192, 16384,
                                              32768, 65536]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[splits] {torch.cuda.get_device_name(0)}; {smi}")
    lib = engine._lib()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(ops, outs, seg, comp=True):
        rows, n = ops[0].shape
        flags = sum(1 << engine._SLOT[o] for o in outs)
        nsplit = -(-n // seg)
        part = torch.empty(lib.repro_fused_reduce_scratch(rows, nsplit),
                           device=dev)
        count = torch.zeros(rows, dtype=torch.int32, device=dev)
        res = torch.empty((len(engine.ALL_OUTPUTS), rows), device=dev)
        y = ops[1].data_ptr() if len(ops) == 2 else None

        def run():
            err = lib.repro_fused_reduce_rows(
                ops[0].data_ptr(), y, rows, n, nsplit, seg, flags, int(comp),
                part.data_ptr(), count.data_ptr(), res.data_ptr(), stream)
            if err:
                raise SystemExit(f"seg {seg}: launch failed ({err})")
            return res
        return run

    cases = []
    for rows, n in cs.REDUCE_SHAPES:
        x = torch.randn((rows, n), generator=g, device=dev) * 4.0 + 1.0
        cases.append((f"[{rows}, {n}] (max, sum, sumsq)", (x,),
                      ("max", "sum", "sumsq"), True))
    n = 1 << 24
    a = torch.randn((1, n), generator=g, device=dev)
    b = torch.randn((1, n), generator=g, device=dev)
    for comp in (True, False):
        cases.append((f"dot of 2^24 pairs, compensated={comp}", (a, b),
                      ("dot",), comp))
    for what, ops, outs, comp in cases:
        n = ops[0].shape[1]
        want = engine.fused_reduce_rows_plain(ops, outputs=outs,
                                              compensated=comp)[0]
        runs = {seg: runner(ops, outs, seg, comp) for seg in segs}
        for seg, run in runs.items():
            got = run()[engine._SLOT[outs[0]]]
            torch.cuda.synchronize()
            if outs[0] == "max" and not torch.equal(got, want):
                raise SystemExit(f"{what} seg {seg}: max differs")
            print(f"[splits] {what} seg {seg} ({-(-n // seg)} splits): "
                  f"max|{outs[0]} kernel-plain| "
                  f"{float((got - want).abs().max()):.3g}")
        times = {seg: [] for seg in runs}
        for _ in range(3):
            for seg, run in runs.items():
                times[seg].append(cs.kernel_ms(run, flush, ("fused_reduce",),
                                               what=f"{what} seg {seg}"))
        for seg, t in times.items():
            print(f"[splits] {what} seg {seg}: "
                  f"{', '.join(f'{v:.4f}' for v in t)} ms (median "
                  f"{statistics.median(t):.4f}; profiler device time, L2 "
                  f"flushed)")
        print(f"[splits] {what}: splits(N) picks seg {engine.splits(n)[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
