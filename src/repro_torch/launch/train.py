"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(twin of ``repro.launch.train``).

Wraps ``train.loop.Trainer`` (checkpoints, the compensated optimizer,
deterministic restartable data, the straggler monitor) on one device:
``--device cuda`` (the default) or ``--device cpu``. Every registry arch
trains (dense, MoE with GQA or MLA, Mamba2, the hybrid, the
encoder-decoder, the vlm with its image patches). Configs are reduced
by default, as in the reference; ``--full`` trains at full width.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.train.loop import Trainer


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-kahan", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    trainer = Trainer(cfg, seq_len=args.seq_len, global_batch=args.batch,
                      lr=args.lr, opt_kahan=not args.no_kahan,
                      n_microbatches=args.micro, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, total_steps=args.steps,
                      seed=args.seed, device=args.device)
    out = trainer.run(args.steps)
    print(f"done: {len(out['history'])} steps, "
          f"final loss {out['history'][-1]['loss']:.4f}, "
          f"stragglers flagged: {len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
