"""Serving telemetry: tracing, metrics, ECM residuals and the attribution
profiler (twin of ``repro.obs``).

  trace      — per-request lifecycle spans on the monotonic ENGINE-STEP
               clock (deterministic; wall time is an optional
               annotation), exported as JSONL and Perfetto-loadable
               Chrome trace JSON
  metrics    — typed Counter/Gauge/Histogram registry; the engine's
               ``metrics_snapshot()`` holds the ``kv_stats`` counters
               value for value and adds distributions (TTFT, queue
               wait) and derived rates, exportable as JSON and
               Prometheus text
  residuals  — each ECM forecast paired with its measured counterpart,
               tagged with the BASIS of the measurement (deterministic
               counter vs wall clock)
  profile    — the ECM attribution profiler (``Telemetry(profile=True)``):
               per-phase flops / bytes counters from the phase's shapes,
               priced on the H100's figures, so a phase's wall time is
               attributed to compute, HBM, host link, dispatch or an
               explicit unattributed bin

``Telemetry`` bundles them behind one handle; ``NULL`` is the always-off
default an engine holds when no telemetry is attached. Every hot-path
hook guards on ``obs.enabled``, so a disabled engine runs the same
launches and the same single host transfer per step as an engine built
before telemetry existed.
"""

from __future__ import annotations

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Metric,
                                     MetricsRegistry)
from repro_torch.obs.residuals import (ResidualLog, ResidualRecord,
                                       residual_row)
from repro_torch.obs.trace import TraceEvent, Tracer


class Telemetry:
    """One recorder handle: a Tracer + MetricsRegistry + ResidualLog
    sharing the engine-step clock. ``wall_clock=True`` also stamps trace
    events with ``time.perf_counter()`` and lets the engine record
    wall-denominated histograms; it never changes the deterministic event
    sequence. ``profile=True`` attaches the ECM attribution ``Profiler``
    (``self.profile``, else None): the engine then records per-phase cost
    counters and wall seconds. The counter side stays deterministic, and
    the Perfetto counter tracks it produces are merged only at
    ``to_chrome()`` export, never into the Tracer's event list."""

    enabled = True

    def __init__(self, wall_clock: bool = False, profile: bool = False):
        self.wall_clock = wall_clock
        self.trace = Tracer(wall_clock)
        self.metrics = MetricsRegistry()
        self.residuals = ResidualLog()
        if profile:
            from repro_torch.obs.profile import Profiler
            self.profile = Profiler()
        else:
            self.profile = None

    def set_step(self, step: int) -> None:
        self.trace.set_step(step)
        if self.profile is not None:
            self.profile.set_step(step)

    def to_chrome(self, path) -> int:
        """Chrome-trace export with the profiler's ECM counter tracks
        appended (when profiling); returns the span/instant count."""
        extra = (self.profile.counter_events()
                 if self.profile is not None else None)
        return self.trace.to_chrome(path, extra_events=extra)


class _NullTelemetry:
    """The disabled recorder: ``enabled`` is False and every hook is a
    no-op, so instrumented components hold it unconditionally and the hot
    path stays one attribute check."""

    enabled = False
    wall_clock = False
    profile = None

    def set_step(self, step: int) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NULL = _NullTelemetry()

__all__ = ["Telemetry", "NULL", "Tracer", "TraceEvent", "MetricsRegistry",
           "Metric", "Counter", "Gauge", "Histogram", "ResidualLog",
           "ResidualRecord", "residual_row"]
# repro_torch.obs.profile (Profiler, Calibration, calibrate) is imported
# lazily: it pulls in the kernels and the ECM model, which plain
# telemetry users (metrics scraping, trace readers) need not pay for.
