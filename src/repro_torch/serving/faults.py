"""Typed serving failures, the logit numerics guard and deterministic
fault injection (twin of ``repro.serving.faults``).

``NumericsGuard`` checks the fused ``_logit_stats`` rows every step: a
NaN/Inf sentinel on the row statistics, and a round-off detector — the
relative deviation between the compensated row sum and a naive f32 sum
of the same row. On the card the naive sum is ``torch.sum``, a tree
reduction whose error grows like log(N) rather than N, so healthy rows
read lower there than on a CPU; the 1e-2 threshold stays, since a
corrupted or catastrophically cancelling row sits orders above both.

``FaultInjector`` is keyed like the engine's sampling streams
(``repro_torch.core.prng`` fold-in chains over (seed, site, step), on
host keys), so its decisions are bitwise the reference's and a failing
run replays from its seed. ``FailoverServer`` retries the requests a
guard quarantined on a degraded engine (bf16 pools, no speculation).
``SwapMissError`` is the host swap tier's typed miss
(``repro_torch.serving.swap``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch import obs
from repro_torch.core import prng


class ServingError(RuntimeError):
    """Base class for recoverable serving-stack failures."""


class AllocatorError(ServingError):
    """Block-pool misuse or exhaustion (alloc beyond the free list,
    double free, retain of a free block)."""


class AdmissionError(ServingError, ValueError):
    """A request that can NEVER be admitted (context overflow, pool
    oversubmit, bad deadline), rejected at submission."""


class SwapMissError(ServingError, KeyError):
    """A host-tier lookup (``KVSwap.swap_in`` / ``KVSwap.drop`` /
    ``PrefixSpill.take``) named a request id or trie path with no
    snapshot. Both directions raise, symmetrically: a drop that misses
    would hide leaked host bytes, a swap-in that misses would resume a
    request on uninitialized KV. Subclasses ``KeyError`` so restore
    contracts written against ``KeyError`` hold."""


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


@dataclass
class FaultSpec:
    """One armed fault at ``site`` (see ``FaultInjector.SITES``). Firing
    policy, in order: ``step`` (exactly at that engine step), ``rate``
    (a keyed Bernoulli draw per step), or with neither, once at the
    first step where the site is reachable."""

    site: str
    step: int | None = None
    rate: float = 0.0
    fired: int = 0


class FaultInjector:
    """Deterministic, replayable fault injection for the serving engine.

    Every stochastic decision (rate draws, victim choices) folds (site,
    step) into ``key(seed)``, so two runs with one seed and workload
    inject the same faults at the same steps; ``self.log`` records
    (step, site, detail) for replay checks. Host rules: the keys and
    draws live on the CPU."""

    SITES = ("kv_corrupt", "logit_nan", "alloc_fail", "proposer_stall")

    def __init__(self, seed: int = 0, faults: list[FaultSpec] | None = None):
        self.seed = seed
        self.faults = list(faults or [])
        for f in self.faults:
            if f.site not in self.SITES:
                raise ValueError(f"unknown fault site {f.site!r}; "
                                 f"expected one of {self.SITES}")
        self.log: list[tuple[int, str, dict]] = []
        # the owning engine's telemetry handle; a firing stamps its own
        # step (the injector may be consulted before the engine advances
        # the shared trace clock)
        self.obs = obs.NULL

    def _key(self, site: str, step: int):
        key = prng.key(self.seed, device="cpu")
        key = prng.fold_in(key, self.SITES.index(site))
        return prng.fold_in(key, step)

    def fire(self, site: str, step: int) -> bool:
        """Whether ``site`` fires at engine step ``step``. Call once per
        (site, step), and only where the site is reachable: one-shot specs
        spend their charge on the first reachable step."""
        for f in self.faults:
            if f.site != site:
                continue
            if f.step is not None:
                if f.step != step:
                    continue
            elif f.rate > 0.0:
                if float(prng.uniform(self._key(site, step))) >= f.rate:
                    continue
            elif f.fired:
                continue
            f.fired += 1
            self.log.append((step, site, {}))
            if self.obs.enabled:
                self.obs.trace.instant("fault_injected", step=step,
                                       site=site)
            return True
        return False

    def choose(self, site: str, step: int, n: int) -> int:
        """Keyed victim index in [0, n) per (seed, site, step), recorded in
        the step's log entry."""
        pick = int(prng.randint(prng.fold_in(self._key(site, step), 1),
                                (), 0, n))
        if self.log and self.log[-1][:2] == (step, site):
            self.log[-1][2]["choice"] = pick
        return pick


class FailoverServer:
    """A primary engine and a degraded engine built on first need.

    Requests the primary quarantines (``DecodeEngine.quarantined``) are
    reset and resubmitted to the degraded engine: by default a plain
    ``DecodeEngine`` over bf16 pools, no speculation. A request that
    trips the guard there too is reported in ``failed``."""

    def __init__(self, primary, degraded_factory=None):
        self.primary = primary
        self._factory = degraded_factory or (
            lambda: degraded_engine(primary))
        self.degraded = None
        self.failed: list = []
        self.retried: list = []

    def submit(self, req) -> None:
        self.primary.submit(req)

    def _sweep(self) -> None:
        tele = self.primary.obs
        for req in self._drain(self.primary):
            req.reset_for_retry()
            if self.degraded is None:
                self.degraded = self._factory()
            self.retried.append(req)
            if tele.enabled:
                tele.trace.instant("failover_retry", rid=req.rid)
            self.degraded.submit(req)
        if self.degraded is not None:
            for req in self._drain(self.degraded):
                req.state = "failed"
                if tele.enabled:
                    tele.trace.instant("failover_failed", rid=req.rid)
                self.failed.append(req)

    @staticmethod
    def _drain(engine) -> list:
        out, engine.quarantined = engine.quarantined, []
        return out

    def step(self) -> None:
        if self.primary.num_unfinished:
            self.primary.step()
        self._sweep()
        if self.degraded is not None and self.degraded.num_unfinished:
            self.degraded.step()

    @property
    def num_unfinished(self) -> int:
        n = self.primary.num_unfinished + len(self.primary.quarantined)
        if self.degraded is not None:
            n += self.degraded.num_unfinished + len(
                self.degraded.quarantined)
        return n

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.num_unfinished:
                return
            self.step()
        self._sweep()
        if self.num_unfinished:
            diags = self.primary.request_diagnostics()
            if self.degraded is not None:
                diags += self.degraded.request_diagnostics()
            raise StallError(
                f"failover server: {self.num_unfinished} requests "
                f"unfinished after {max_steps} steps", diags)


def degraded_engine(primary):
    """``FailoverServer``'s default degraded tier: a plain
    ``DecodeEngine`` (no speculation) over bf16 pools with the primary's
    geometry, guard, device and telemetry (one step clock, one event
    stream). Fault injection does not follow the request there."""
    from repro_torch.serving.engine import DecodeEngine

    return DecodeEngine(
        primary.cfg.with_(kv_dtype="bf16"), primary.params,
        max_slots=primary.max_slots,
        max_context=primary.layout.max_context,
        block_size=primary.layout.block_size,
        prefill_chunk=primary.scheduler.prefill_chunk,
        guard=primary.guard, device=primary.device,
        telemetry=primary.obs if primary.obs.enabled else None)
