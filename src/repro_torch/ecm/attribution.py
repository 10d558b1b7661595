"""Per-phase ECM attribution: where did the wall time go? (twin of
``repro.ecm.attribution``, pure arithmetic.)

The paper's method is not to *measure* runtime but to *account* for it:
pair hardware transfer/instruction counters with the ECM machine model
so every cycle is attributed to a bottleneck (in-core compute vs a
memory-hierarchy transfer), and whatever the model cannot explain is
surfaced explicitly instead of silently absorbed. This module is that
accounting step for the serving engine's phases.

Inputs per phase (collected by ``repro_torch.obs.profile.Profiler``):

  counter basis — deterministic, reproducible bit-for-bit on a seeded
    workload: kernel launches, flops (dot vs elementwise, from the
    phase's cost function of the config and its shapes), HBM bytes
    accessed, host-link bytes moved. Two identical seeded runs produce
    identical tables.
  wall basis — measured seconds per phase on this host.

The ECM decomposition prices the counters on the machine passed as
``hw`` (default ``repro_torch.ecm.machines.H100_SXM``: ``peak_flops``
for the dot flops, the tensor cores; ``f32_flops`` for the rest, the
CUDA cores) and rescales by the profiler's measured ``machine_scale``
(the calibration kernel's measured streaming time over the model's), so
the categories are host-comparable:

    t_compute  = scale * (dot_flops / peak_flops + elem_flops / f32_flops)
    t_hbm      = scale * hbm_bytes / hbm_bw
    t_host     = scale * host_bytes / host_link_bw
    t_dispatch = calls * dispatch_s          (measured per-launch cost)
    unattributed = wall - sum(above)         (never hidden, may be the
                                              largest bin on a CPU host
                                              where Python scheduling
                                              dominates)

``bound`` names the largest attributed category — the phase-level
analog of the paper's "which ECM term saturates" verdict. The rendered
report reads like the paper's breakdowns:

    decode_step: 61% hbm, 22% dispatch, 9% host, 8% unattributed
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.ecm.machines import H100_SXM

# Attributed-time categories, in render order. "unattributed" is the
# explicit residual bin, never a category we model.
CATEGORIES = ("compute", "hbm", "host", "dispatch")


@dataclass(frozen=True)
class PhaseAttribution:
    """One phase's cycle accounting: deterministic counters plus the
    wall-time decomposition. The counter columns (calls/flops/dot_flops/
    hbm_bytes/host_bytes) are the reproducible identity of the phase;
    everything in seconds is host-measured or host-scaled."""

    phase: str
    # counter basis (deterministic on a seeded workload)
    calls: int
    flops: float
    dot_flops: float
    hbm_bytes: float
    host_bytes: float
    # wall basis (this host, this run)
    wall_s: float
    t_compute_s: float
    t_hbm_s: float
    t_host_s: float
    t_dispatch_s: float
    t_unattributed_s: float
    bound: str
    warnings: tuple = field(default_factory=tuple)

    @property
    def fractions(self) -> dict:
        """Share of measured wall time per category (0 when no wall)."""
        w = self.wall_s
        if w <= 0.0:
            return {c: 0.0 for c in CATEGORIES + ("unattributed",)}
        return {"compute": self.t_compute_s / w,
                "hbm": self.t_hbm_s / w,
                "host": self.t_host_s / w,
                "dispatch": self.t_dispatch_s / w,
                "unattributed": self.t_unattributed_s / w}

    def counter_row(self) -> tuple:
        """The deterministic identity of this phase: equal across two
        identical seeded runs (the wall columns are not)."""
        return (self.phase, self.calls, round(self.flops, 3),
                round(self.dot_flops, 3), round(self.hbm_bytes, 3),
                round(self.host_bytes, 3))

    def to_json(self) -> dict:
        d = {"phase": self.phase, "calls": self.calls,
             "flops": self.flops, "dot_flops": self.dot_flops,
             "hbm_bytes": self.hbm_bytes, "host_bytes": self.host_bytes,
             "wall_s": self.wall_s, "t_compute_s": self.t_compute_s,
             "t_hbm_s": self.t_hbm_s, "t_host_s": self.t_host_s,
             "t_dispatch_s": self.t_dispatch_s,
             "t_unattributed_s": self.t_unattributed_s,
             "bound": self.bound,
             "fractions": self.fractions}
        if self.warnings:
            d["warnings"] = list(self.warnings)
        return d


def attribute_phase(phase: str, *, calls: int, flops: float,
                    dot_flops: float, hbm_bytes: float, host_bytes: float,
                    wall_s: float, machine_scale: float = 1.0,
                    dispatch_s: float = 0.0,
                    hw: dict = H100_SXM) -> PhaseAttribution:
    """Price one phase's counters on the (host-scaled) ECM machine.

    ``machine_scale`` is measured by the profiler's Kahan-dot
    calibration (this host's streaming time over the model's); without
    it the H100-model terms on a CPU host would attribute ~nothing and
    everything would land in "unattributed".
    """
    elem_flops = max(flops - dot_flops, 0.0)
    t_compute = machine_scale * (dot_flops / hw["peak_flops"]
                                 + elem_flops / hw["f32_flops"])
    t_hbm = machine_scale * hbm_bytes / hw["hbm_bw"]
    t_host = machine_scale * host_bytes / hw["host_link_bw"]
    t_dispatch = calls * dispatch_s
    attributed = t_compute + t_hbm + t_host + t_dispatch
    unattributed = max(wall_s - attributed, 0.0)
    warnings = ()
    if wall_s > 0.0 and attributed > wall_s * 1.5:
        warnings = (f"model over-attributes: {attributed:.2e}s priced vs "
                    f"{wall_s:.2e}s measured — calibration is stale or the "
                    f"phase overlaps launches",)
    terms = {"compute": t_compute, "hbm": t_hbm, "host": t_host,
             "dispatch": t_dispatch}
    bound = max(terms, key=lambda c: terms[c]) if attributed > 0 else "none"
    if unattributed > attributed:
        bound = "unattributed"
    return PhaseAttribution(
        phase=phase, calls=calls, flops=flops, dot_flops=dot_flops,
        hbm_bytes=hbm_bytes, host_bytes=host_bytes, wall_s=wall_s,
        t_compute_s=t_compute, t_hbm_s=t_hbm, t_host_s=t_host,
        t_dispatch_s=t_dispatch, t_unattributed_s=unattributed,
        bound=bound, warnings=warnings)


def render(attributions: list) -> str:
    """The paper-style text report, one line per phase:

        decode_step: 38 calls 1.2e+08 flops 3.4 MiB hbm | 2.1 ms/call:
        61% hbm, 22% dispatch, 9% host, 8% unattributed (bound: hbm)
    """
    lines = ["ECM attribution (categories priced on the calibrated "
             "machine model; unattributed is the explicit residual)"]
    for a in attributions:
        fr = a.fractions
        pct = ", ".join(
            f"{fr[c] * 100:.0f}% {c}"
            for c in CATEGORIES + ("unattributed",)
            if fr[c] >= 0.005 or c == "unattributed")
        per_call = a.wall_s / a.calls if a.calls else 0.0
        lines.append(
            f"  {a.phase}: {a.calls} calls {a.flops:.3g} flops "
            f"{a.hbm_bytes / 2**20:.2f} MiB hbm "
            f"{a.host_bytes / 2**20:.2f} MiB host | "
            f"{per_call * 1e6:.0f} us/call: {pct} (bound: {a.bound})")
        for w in a.warnings:
            lines.append(f"    ! {w}")
    return "\n".join(lines)
