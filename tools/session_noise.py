"""The session pairs' own noise on the card, from seeds the smoke run does
not judge.

    python3 tools/session_noise.py [--out PATH]

``chip_smoke.py``'s ``[session]`` phase holds a prefix-caching engine's
multi-turn streams to a cold replay of every turn. A later turn's prefill
reads the previous turn's decode-written K/V entries, which round apart
from the cold replay's prefill-written ones, so the two streams part at
near-ties. The phase's limits must not come from the run it judges: a
session-KV fault would raise them with the error they are there to catch.
This script runs ``chip_smoke.session_pairs`` (qwen1.5-0.5b at full
width, bf16 pools, random weights of ``chip_smoke.SEED``) on each seed of
``chip_smoke.SESSION_CALIB_SEEDS`` and reports, per seed and over all of
them:

- ``lp``: the largest |warm - cold| logprob of a token emitted before the
  two streams part (``SESSION_NOISE`` is the largest over the seeds);
- ``steps``: per layer, the largest decode-written vs prefill-written
  entry distance in storage steps (``SESSION_STEPS`` is the largest);
- each parting: request, token index and its row's top-2 gap.

The phase's own seed, ``SESSION_SEED``, is run last and reported apart;
it sets nothing. Prints the card's name and power limit first and one JSON
object as the last line (also written to ``--out``); exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def reading(r: dict) -> dict:
    """A ``session_pairs`` result as numbers: lp, steps, partings."""
    cold = {c.rid: c.output for c in r["cold"]}
    partings = []
    for w in r["warm"]:
        p = next((i for i, (a, b) in enumerate(zip(w.output, cold[w.rid]))
                  if a != b), None)
        if p is not None:
            partings.append({"rid": w.rid, "token": p,
                             "gap": r["probe"].gaps.get(w.rid, {}).get(p)})
    return {"lp": r["lp"], "steps": r["steps"], "max_steps": max(r["steps"]),
            "hits": r["hits"], "partings": partings}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("session_noise: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch import device as _device
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import api
    _device.set_numerics()
    print(f"build {_build.build_all():.1f} s", flush=True)
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-0.5b")
    params = api.init_params(cfg, device=dev, seed=cs.SEED)
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "seeds": {}}
    for seed in (*cs.SESSION_CALIB_SEEDS, cs.SESSION_SEED):
        t0 = time.perf_counter()
        rd = reading(cs.session_pairs(dev, cfg, params, seed))
        rd["seconds"] = time.perf_counter() - t0
        res["seeds"][str(seed)] = rd
        print(json.dumps({"seed": seed, **rd}), flush=True)
    calib = [res["seeds"][str(s)] for s in cs.SESSION_CALIB_SEEDS]
    res["SESSION_NOISE"] = max(rd["lp"] for rd in calib)
    res["SESSION_STEPS"] = max(rd["max_steps"] for rd in calib)
    res["layer0_max"] = max(rd["steps"][0] for rd in calib)
    res["calib_gap_max"] = max((p["gap"] for rd in calib
                                for p in rd["partings"]), default=None)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({k: v for k, v in res.items() if k != "seeds"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
