"""Training loop: the step, checkpoints, straggler monitoring and the
compensated cross-step loss accumulator (twin of ``repro.train.loop``).

The loop is restart-transparent: the state (params, optimizer state,
step) lives in the checkpoint and the data is a pure function of the
step (``data.pipeline``), so a killed run resumes from its last
published checkpoint bitwise where it would have been
(tests/test_torch_checkpoint.py). The device is explicit: ``cuda`` by
default (raising without a GPU), ``device="cpu"`` for the plain path.
The training tree is f32 (``api.init_params(..., hold_bf16=False)``),
one tensor per leaf, for every family ``api.loss_fn`` dispatches to; a
vlm's batches carry ``patch_embeds``, an audio model's ``frames``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch import device as _device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.kahan import KahanState, tree_map
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import steps as step_builders


@dataclass
class StragglerMonitor:
    """EWMA step-time tracker: flags a step slower than ``threshold``
    times the EWMA of the steps before it (outliers stay out of the
    EWMA, so one straggler does not mask the next)."""
    alpha: float = 0.1
    threshold: float = 3.0
    ewma: float | None = None
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = dt > self.threshold * self.ewma
        if is_straggler:
            self.flagged.append((step, dt, self.ewma))
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


class Trainer:
    def __init__(self, cfg: ModelConfig, *, seq_len: int = 128,
                 global_batch: int = 8, lr: float = 3e-4,
                 opt_kahan: bool = True, n_microbatches: int = 1,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 warmup: int = 10, total_steps: int = 1000,
                 fused_grad_stats: bool = True, seed: int = 0,
                 device=None):
        self.device = _device.resolve(device)
        if self.device.type == "cuda":
            _device.set_numerics()
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.opt_cfg = adamw.AdamWConfig(lr=lr, kahan=opt_kahan)
        self.pipeline = SyntheticTokenPipeline(cfg, seq_len, global_batch)
        schedule = lambda s: adamw.warmup_cosine(s, warmup=warmup,
                                                 total=total_steps)
        self._step_fn = step_builders.build_train_step(
            cfg, self.opt_cfg, schedule=schedule,
            n_microbatches=n_microbatches,
            fused_grad_stats=fused_grad_stats)
        self.ckpt = (CheckpointManager(ckpt_dir, keep_last=3)
                     if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.monitor = StragglerMonitor()
        zero = torch.zeros((), dtype=torch.float32)
        self.metrics_acc = KahanState({"loss": zero}, {"loss": zero})
        self.seed = seed

        self.step = 0
        self.params = None
        self.opt_state = None

    # ------------------------------------------------------------ state ---

    def init_state(self):
        # the init's per-layer leaves are views of stacked tensors: one
        # allocation per leaf instead, as a restored tree has
        self.params = tree_map(torch.clone, api.init_params(
            self.cfg, device=self.device, seed=self.seed, hold_bf16=False))
        self.opt_state = adamw.init(self.params, self.opt_cfg)
        self.step = 0

    def state_tree(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "step": torch.tensor(self.step, dtype=torch.int64)}

    def maybe_restore(self) -> bool:
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        self.init_state()      # structure template
        restored = self.ckpt.restore(latest, self.state_tree())
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = int(restored["step"])
        return True

    # ------------------------------------------------------------ run -----

    def _device_batch(self, batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def run(self, num_steps: int, *, log_every: int = 10,
            inject_delay=None) -> dict:
        if self.params is None and not self.maybe_restore():
            self.init_state()
        history = []
        it = self.pipeline.iterate(start_step=self.step)
        for step, batch in it:
            if step >= self.step + num_steps:
                it.close()                 # stops the prefetch thread
                break
            t0 = time.perf_counter()
            if inject_delay is not None:
                inject_delay(step)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, self._device_batch(batch),
                step)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.monitor.observe(step, dt)
            # compensated cross-step loss accumulation (the paper's
            # technique at the metrics layer, on the host)
            self.metrics_acc = self.metrics_acc.add(
                {"loss": torch.tensor(loss, dtype=torch.float32)})
            history.append({"step": step, "loss": loss, "dt": dt,
                            "metrics": metrics})
            if self.ckpt and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, dict(
                    self.state_tree(),
                    step=torch.tensor(step + 1, dtype=torch.int64)))
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
        self.step = history[-1]["step"] + 1 if history else self.step
        if self.ckpt:
            self.ckpt.save(self.step, self.state_tree())
            self.ckpt.wait()
        return {"history": history,
                "mean_loss": float(self.metrics_acc.value()["loss"])
                / max(len(history), 1),
                "stragglers": self.monitor.flagged}
