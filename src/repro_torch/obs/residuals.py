"""ECM predicted-vs-measured residuals (twin of ``repro.obs.residuals``).

The paper's method lives or dies on comparing an analytic forecast
against a measurement (Hofmann et al.: ECM cycle predictions vs measured
cycles, kernel by kernel). The serving stack makes standing
forecasts (``repro_torch.ecm.hopper``: ``predicted_prefill_speedup``,
``predicted_spec_speedup``, ``predicted_restore_vs_reprefill``, the
compensated dot's ``kahan_overhead``) and a run measures their
counterparts. A *residual record*
pairs the two, plus the one bit the trajectory needs to interpret a
moved number: the **basis** of the measured side.

``basis="counter"``
    The measured side is a deterministic engine counter (tokens, bytes
    ratio, acceptance rate). Seeded workloads reproduce it bitwise on
    any host, so a moved counter-basis residual is a CODE change (or a
    deliberate workload redefinition) — never noise. The regression
    gate hard-fails on these.

``basis="wallclock"``
    The measured side involves wall time (tok/s ratios). It drifts with
    the host; the gate reports a moved wallclock-basis residual as
    *possible host drift* instead of failing, and a persistent gap at a
    STABLE counter basis is model error — the quantity the paper plots.

Residual rows ride the normal bench-row stream (name prefix
``ecm_residual/``), so they land in the per-commit ``BENCH_<sha>.json``
with no extra plumbing and the trajectory accumulates predicted,
measured and ratio per forecast per commit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

BASES = ("counter", "wallclock")

# Residual rows in the bench CSV/JSON all share this name prefix; a
# compare gate keys off it (and off the ``basis=`` field) when deciding
# what may hard-fail a change.
ROW_PREFIX = "ecm_residual"


@dataclass
class ResidualRecord:
    """One forecast paired with its measured counterpart."""

    name: str                   # e.g. "decode_speedup/int8-l4"
    predicted: float
    measured: float
    basis: str                  # "counter" | "wallclock"
    context: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.basis not in BASES:
            raise ValueError(f"basis must be one of {BASES}, "
                             f"got {self.basis!r}")

    @property
    def ratio(self) -> float:
        """measured / predicted — 1.0 means the model nailed it; the
        bench rows report this so the trajectory plots model error
        directly."""
        return self.measured / self.predicted if self.predicted else float("inf")

    def to_row(self) -> tuple:
        """A bench row: (name, us_per_call, derived) like every other
        benchmark emits, so a row writer needs no special case."""
        extra = "".join(f" {k}={v}" for k, v in sorted(self.context.items()))
        return (f"{ROW_PREFIX}/{self.name}", "0",
                f"predicted={self.predicted:.4f}"
                f" measured={self.measured:.4f}"
                f" ratio={self.ratio:.4f}"
                f" basis={self.basis}" + extra)


class ResidualLog:
    """Accumulates residual records over a run (one per forecast the
    engine/bench exercised); ``rows()`` hands them to the bench stream."""

    def __init__(self):
        self.records: list[ResidualRecord] = []

    def __len__(self) -> int:
        return len(self.records)

    def record(self, name: str, predicted: float, measured: float, *,
               basis: str, **context) -> ResidualRecord:
        rec = ResidualRecord(name, float(predicted), float(measured),
                             basis, context)
        self.records.append(rec)
        return rec

    def rows(self) -> list[tuple]:
        return [rec.to_row() for rec in self.records]


def residual_row(name: str, predicted: float, measured: float, *,
                 basis: str, **context) -> tuple:
    """One-shot helper for benches that don't keep a log around."""
    return ResidualRecord(name, float(predicted), float(measured), basis,
                          context).to_row()
