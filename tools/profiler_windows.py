"""How often ``torch.profiler`` drops a window on this card, and whether
keeping CUPTI set up between windows stops it.

    python3 tools/profiler_windows.py [--windows N]

``chip_smoke.py``'s times phase opens one profiler window per measurement,
about a hundred in one process. Now and then a window came back with no
device event at all, two or three windows running. This script opens
``N`` windows in each of three child processes, the same kinds
``chip_smoke.kernel_ms`` opens (the L2 flush alone; one call; twenty
calls, each after a flush) over cuBLAS and SDPA calls at the times
phase's shapes, and counts the windows without a device event and the
windows whose device-kernel count differs from the count most windows of
their kind show (events that a dropped window lost and a later one
gained would show there):

- ``teardown``: PyTorch's default, CUPTI torn down after each window and
  set up again for the next;
- ``kept``: ``TEARDOWN_CUPTI=0`` in the environment, so CUPTI stays set
  up for the process's life;
- ``pause``: the default, and half a second of sleep after each empty
  window before the next one.

Prints one JSON line per child and exits non-zero when the card is
missing. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter

MODES = {"teardown": None, "kept": "0", "pause": None}


def child(windows: int, pause: float) -> dict:
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    a8 = torch.randn(8, 2816, generator=g, device=dev)
    a = torch.randn(2048, 2816, generator=g, device=dev)
    w = torch.randn(2816, 1024, generator=g, device=dev)
    ab, wb = a.bfloat16(), w.bfloat16()
    q = torch.randn(4, 16, 2048, 64, generator=g, device=dev).bfloat16()
    calls = [lambda: torch.matmul(a8, w), lambda: torch.matmul(a, w),
             lambda: torch.matmul(ab, wb),
             lambda: F.scaled_dot_product_attention(q, q, q, is_causal=True)]
    for fn in calls:
        fn()
    torch.cuda.synchronize()

    def window(fn, with_flush: bool, reps: int) -> int:
        """Device kernel launches the window recorded."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if with_flush:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        return sum(ev.count for ev in prof.key_averages()
                   if getattr(ev, "device_type", None) == DeviceType.CUDA)

    empty, counts = [], {}
    t0 = time.perf_counter()
    for i in range(windows):
        fn_i = (i // 3) % len(calls)
        fn = calls[fn_i]
        kind = i % 3
        n = (window(flush.zero_, False, 3) if kind == 0 else
             window(fn, False, 1) if kind == 1 else window(fn, True, 20))
        if n == 0:
            empty.append(i)
            time.sleep(pause)
        else:
            counts.setdefault((fn_i, kind), []).append((i, n))
    secs = time.perf_counter() - t0
    odd = []
    for seen in counts.values():
        usual = Counter(n for _, n in seen).most_common(1)[0][0]
        odd += [(i, n, usual) for i, n in seen if n != usual]
    tail = empty and all(j in empty for j in range(empty[0], windows))
    run = longest = 0
    for i in range(windows):
        run = run + 1 if i in empty else 0
        longest = max(longest, run)
    return dict(windows=windows, empty=len(empty), first_empty=empty[:5],
                empty_from_first_to_end=bool(tail), longest_run=longest,
                odd_counts=len(odd), first_odd=sorted(odd)[:5],
                ms_per_window=round(1e3 * secs / windows, 3),
                torch=torch.__version__, cuda=torch.version.cuda)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=600)
    ap.add_argument("--child", choices=sorted(MODES))
    args = ap.parse_args()
    if args.child:
        pause = 0.5 if args.child == "pause" else 0.0
        print(json.dumps(dict(mode=args.child, **child(args.windows, pause))),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA GPU", file=sys.stderr)
        return 1
    rc = 0
    for mode, value in MODES.items():
        env = dict(os.environ)
        env.pop("TEARDOWN_CUPTI", None)
        if value is not None:
            env["TEARDOWN_CUPTI"] = value
        rc |= subprocess.run([sys.executable, __file__, "--child", mode,
                              "--windows", str(args.windows)],
                             env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
