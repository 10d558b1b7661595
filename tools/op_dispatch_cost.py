"""Host cost of calling a kernel launcher through a PyTorch custom
operator, against calling it directly.

``kernels.traced`` registers each card kernel as an operator
(``torch.library.custom_op``) for traced calls only: a plain tensor
still reaches the launcher directly, because a decode step makes
hundreds of kernel calls. This script measures what the operator adds
per call: a launcher-shaped function that only allocates its output,
called directly and through an operator, on CPU tensors (the
dispatcher's path is the same for CUDA ones).

  PYTHONPATH=src python tools/op_dispatch_cost.py [--calls 20000]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch


def launcher(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.empty_like(x)


def per_call_us(fn, args, calls: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean host microseconds a call."""
    for _ in range(calls // 10):
        fn(*args)
    out = []
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        out.append((time.perf_counter() - t) / calls * 1e6)
    return statistics.median(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=20000)
    args = ap.parse_args()
    op = torch.library.custom_op(
        "op_dispatch_cost::launcher", launcher, mutates_args=(),
        schema="(Tensor x, Tensor w, float eps) -> Tensor")
    op.register_fake(lambda x, w, eps: torch.empty_like(x))
    x, w = torch.zeros(1024), torch.zeros(1024)
    direct = per_call_us(launcher, (x, w, 1e-6), args.calls)
    through = per_call_us(op._opoverload, (x, w, 1e-6), args.calls)
    print(json.dumps({"torch": torch.__version__, "direct_us": direct,
                      "operator_us": through,
                      "added_us": through - direct}))


if __name__ == "__main__":
    main()
