"""Typed serving failures and the logit numerics guard (the first half of
``repro.serving.faults``; fault injection and failover wait for ROADMAP
queue A item 8).

``NumericsGuard`` checks the fused ``_logit_stats`` rows every step: a
NaN/Inf sentinel on the row statistics, and a round-off detector — the
relative deviation between the compensated row sum and a naive f32 sum
of the same row. On the card the naive sum is ``torch.sum``, a tree
reduction whose error grows like log(N) rather than N, so healthy rows
read lower there than on a CPU; the 1e-2 threshold stays, since a
corrupted or catastrophically cancelling row sits orders above both.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class ServingError(RuntimeError):
    """Base class for recoverable serving-stack failures."""


class AllocatorError(ServingError):
    """Block-pool misuse or exhaustion (alloc beyond the free list,
    double free, retain of a free block)."""


class AdmissionError(ServingError, ValueError):
    """A request that can NEVER be admitted (context overflow, pool
    oversubmit, bad deadline), rejected at submission."""


class ProposerStallError(ServingError):
    """A speculative-decoding proposer failed to produce drafts this
    step. The spec engine degrades the step to the plain verify-path
    decode (k == 0 for every slot) instead of crashing."""


class StallError(ServingError):
    """``run_until_done`` exhausted ``max_steps`` with unfinished
    requests; carries per-request diagnostics."""

    def __init__(self, msg: str, diagnostics: list[dict]):
        super().__init__(msg)
        self.diagnostics = diagnostics


@dataclass
class NumericsGuard:
    """Per-step logit health checks; ``None`` threshold disables the
    round-off detector, ``check_nonfinite=False`` the NaN/Inf sentinel."""

    check_nonfinite: bool = True
    round_off_threshold: float | None = 1e-2

    def check_row(self, stats: dict, idx: int) -> str | None:
        """Reason string if row ``idx`` trips a detector, else None."""
        if self.check_nonfinite:
            for key in ("max", "logsumexp", "rms"):
                if not np.all(np.isfinite(np.asarray(stats[key])[idx])):
                    return f"nonfinite {key}"
        if self.round_off_threshold is not None and "round_off" in stats:
            dev = np.max(np.asarray(stats["round_off"])[idx])
            if not np.isfinite(dev) or dev > self.round_off_threshold:
                return f"round_off {dev:.3g}"
        return None

    def check_rows(self, stats: dict) -> dict[int, str]:
        """``check_row`` over every row at once: {idx: reason} for the
        tripped rows only (first detector to trip names the reason)."""
        reasons: dict[int, str] = {}
        if self.check_nonfinite:
            for key in ("max", "logsumexp", "rms"):
                a = np.asarray(stats[key])
                finite = np.isfinite(a).reshape(a.shape[0], -1).all(axis=1)
                for i in np.nonzero(~finite)[0]:
                    reasons.setdefault(int(i), f"nonfinite {key}")
        if self.round_off_threshold is not None and "round_off" in stats:
            dev = np.asarray(stats["round_off"])
            dev = dev.reshape(dev.shape[0], -1).max(axis=1)
            bad = ~np.isfinite(dev) | (dev > self.round_off_threshold)
            for i in np.nonzero(bad)[0]:
                reasons.setdefault(int(i), f"round_off {dev[i]:.3g}")
        return reasons
