"""The lm one-shot server against the engine, and what a served prefill
costs, for one checkout of the port.

    python3 tools/oneshot_streams.py [--root DIR] [--arch qwen1.5-0.5b|
                                     deepseek-v2-236b] [--prompts 8]
                                     [--out PATH]

``--root`` (default: this checkout) is the checkout whose ``src/`` and
``chip_smoke.py`` are imported, so one call can measure two commits
(unpack the other with ``git archive`` into a directory ``.gitignore``
lists). On the card, at full width (deepseek-v2 cut to chip_smoke's 3
layers), random weights of ``chip_smoke.SEED``:

- the ``DecodeEngine`` (``chip_smoke.SERVE_KW``: 8 slots, chunks of 256)
  serves ``chip_smoke.make_requests`` (16 prompts of 64-512 tokens, 32
  new tokens each): the greedy streams;
- the one-shot server (``build_prefill_step`` + ``build_serve_step``, as
  chip_smoke's ``[oneshot]``) serves the first ``--prompts`` prompts one
  at a time: how many streams equal the engine's, and at which output
  index the others part;
- device ms of one 256-token prefill chunk (``chip_smoke.ssm_prefill_ms``:
  profiler device time and CUDA events) and the CUDA-event ms of each
  one-shot prefill.

Prints the card's name and power limit first and one JSON object as the
last line (also written to ``--out``); exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def measure(dev, arch: str, prompts: int) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.train import steps as tsteps
    cfg = get_config(arch)
    if cfg.mla is not None:
        cfg = cfg.with_(num_layers=3)           # chip_smoke's deepseek-v2
    params = api.init_params(cfg, device=dev, seed=cs.SEED)
    reqs = cs.make_requests(cfg)
    engine = DecodeEngine(cfg, params, device=dev, **cs.SERVE_KW)
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    base = {r.rid: list(r.output) for r in reqs}
    prefill = tsteps.build_prefill_step(cfg, cs.SERVE_KW["max_context"])
    serve = tsteps.build_serve_step(cfg)
    partings, prefill_ms = {}, []
    for r in reqs[:prompts]:
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        tok, caches = prefill(params, {"tokens": torch.tensor(
            [r.prompt], dtype=torch.int32, device=dev)})
        end.record()
        stream, cur = [int(tok[0])], tok[:, None]
        for _ in range(len(base[r.rid]) - 1):
            cur, caches = serve(params, caches, cur)
            stream.append(int(cur[0, 0]))
        torch.cuda.synchronize()
        prefill_ms.append(round(start.elapsed_time(end), 4))
        i = next((j for j, (a, b) in enumerate(zip(stream, base[r.rid]))
                  if a != b), None)
        if i is not None:
            partings[r.rid] = i
        del caches
    busy, event = cs.ssm_prefill_ms(dev, cfg, params)
    return dict(arch=cfg.name, layers=cfg.num_layers, prompts=prompts,
                prompt_tokens=[len(r.prompt) for r in reqs[:prompts]],
                equal=prompts - len(partings), partings=partings,
                oneshot_prefill_ms=prefill_ms,
                chunk256_busy_ms=busy, chunk256_event_ms=event)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=("qwen1.5-0.5b", "deepseek-v2-236b"))
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("oneshot_streams: needs a CUDA GPU", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    from repro_torch import device as _device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    _device.set_numerics()
    res = measure(torch.device("cuda"), args.arch, args.prompts)
    out = dict(device=smi, root=str(root), result=res)
    print(f"{res['arch']} ({root}): one-shot streams equal to the engine's "
          f"{res['equal']} of {res['prompts']}, partings (request: output "
          f"index) {res['partings']}; 256-token prefill chunk "
          f"{res['chunk256_busy_ms']:.3f} ms device busy "
          f"({res['chunk256_event_ms']:.3f} ms events); one-shot prefills "
          f"{res['oneshot_prefill_ms']} ms for {res['prompt_tokens']} tokens")
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
