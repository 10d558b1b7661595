"""The one-shot server's profiled decode window, in a process of its own.

    python3 tools/oneshot_window.py [--arch whisper-tiny] [--out PATH]

``chip_smoke.py``'s ``[oneshot]`` phase profiles 4 decode steps of each
one-shot model after its runs. Late in that long process, whisper-tiny's
window held 15 of its 16 B1 split + merge pairs on every try (the same
window in a fresh process holds all 16), so the phase then runs this
script, which traces the window in a process of its own: the phase's
model and inputs
(``chip_smoke.oneshot_inputs``, random weights of ``chip_smoke.SEED``,
the LoRA drawn for zamba2), one ``chip_smoke.oneshot_run`` of 32 greedy
steps over bf16 pools, then ``chip_smoke.oneshot_profile``: device busy
ms, kernels and the idle share per decode step, held to the exact B1
launch counts. Prints the card's name and power limit first and one JSON
object as the last line (also written to ``--out``); exits non-zero
without a card or when the window is not measured.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper-tiny",
                    choices=("whisper-tiny", "zamba2-1.2b"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("oneshot_window: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import device as _device
    from repro_torch.configs import get_config
    from repro_torch.models import api
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    _device.set_numerics()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    prompt = 256 if cfg.family == "hybrid" else 16
    per_step = (cfg.num_layers // cfg.hybrid.segment_len
                if cfg.family == "hybrid" else cfg.num_layers)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 13)
    params = api.init_params(cfg, device=dev, seed=cs.SEED)
    if cfg.family == "hybrid":
        cs._lora_draws(params, g)
    batch = cs.oneshot_inputs(cfg, dev, g, prompt)
    cache = prompt + cs.ONESHOT_STEPS + cs.ONESHOT_PROFILE_STEPS + 8
    run = cs.oneshot_run(cfg, params, batch, cache, want_attn={
        "paged_attention": per_step * cs.ONESHOT_STEPS})
    prof = cs.oneshot_profile(cfg, params, run["caches"],
                              run["tokens"][:, -1:].to(dev), per_step,
                              f"{args.arch} bf16")
    out = dict(device=smi, arch=args.arch, window=prof,
               step_ms=run["step_ms"], prefill_ms=run["prefill_ms"])
    text = json.dumps(out)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0 if prof is not None else 1


if __name__ == "__main__":
    sys.exit(main())
