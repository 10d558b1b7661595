"""Typed metrics registry: counters, gauges, histograms (twin of
``repro.obs.metrics``; plain Python, exports equal to the reference's).

The engine's legacy ``kv_stats`` dict mixed deterministic counters
(bytes, tokens, blocks, trips) with nothing to hold distributions (TTFT,
queue wait) or wall-clock timings. This registry separates the three
kinds explicitly:

``Counter``
    Monotonic deterministic accumulators — the bitwise-reproducible
    series the perf-trajectory regression gate trusts. The engine's
    ``metrics_snapshot()`` mirrors every ``kv_stats`` key into one of
    these verbatim, so the snapshot subsumes ``kv_stats`` value-for-value.

``Gauge``
    Last-value observations (derived rates like prefix hit rate and
    acceptance rate, pool residency).

``Histogram``
    Distributions over fixed bucket bounds (TTFT in engine steps, queue
    wait, per-step wall latency). Step-denominated histograms stay
    deterministic; wall-clock ones are explicitly timing-side.

Two exports: ``snapshot()`` (plain dict, what a JSON metrics export or a
benchmark row reads) and ``to_prometheus()``
(the text exposition format, one ``# TYPE`` block per metric, histogram
as ``_bucket``/``_sum``/``_count`` plus summary-style
``{quantile="0.5|0.95|0.99"}`` estimate lines). ``summary()`` carries the
same p50/p95/p99 (bucket-interpolated — resolution-bounded estimates,
not exact order statistics).
"""

from __future__ import annotations

import math

# Default histogram bucket upper bounds, in the unit of the metric
# (engine steps or seconds). Geometric-ish coverage from interactive to
# pathological; +Inf is implicit.
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


class Metric:
    """Base: a named, typed, unit-annotated series."""

    kind = "untyped"

    def __init__(self, name: str, unit: str = "", help: str = ""):
        self.name = name
        self.unit = unit
        self.help = help


class Counter(Metric):
    """Monotonic accumulator. ``inc`` rejects negative deltas — a
    counter that can go down is a gauge and would silently break the
    deterministic-series regression gate."""

    kind = "counter"

    def __init__(self, name: str, unit: str = "", help: str = ""):
        super().__init__(name, unit, help)
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        self.value += n

    def set(self, v: int | float) -> None:
        """Absolute update for counters mirrored from an external source
        (``kv_stats``); still must not move backwards."""
        if v < self.value:
            raise ValueError(f"counter {self.name}: {v} < {self.value}")
        self.value = v


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name: str, unit: str = "", help: str = ""):
        super().__init__(name, unit, help)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, unit: str = "", help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        super().__init__(name, unit, help)
        if list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must ascend")
        self.buckets = tuple(buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (q in [0, 1]).

        Linear interpolation within the bucket holding the q-th
        observation — the standard Prometheus ``histogram_quantile``
        estimate, bounded by the bucket resolution. Observations in the
        +Inf bucket report the observed max (the only bound we have)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if not self.count:
            return 0.0
        target = q * self.count
        acc, lo = 0, 0.0
        for ub, c in zip(self.buckets, self.bucket_counts):
            if c and acc + c >= target:
                return min(lo + (target - acc) / c * (ub - lo), self.max)
            acc += c
            lo = ub
        return self.max

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Ordered name -> metric map with get-or-create accessors.

    Re-registering a name with the same kind returns the existing
    metric (components can share series without plumbing references);
    re-registering with a DIFFERENT kind is a hard error — one name,
    one type, or the Prometheus exposition would be self-contradictory.
    """

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str) -> Metric:
        return self._metrics[name]

    def _get(self, cls, name: str, unit: str, help: str, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m
        m = self._metrics[name] = cls(name, unit, help, **kw)
        return m

    def counter(self, name: str, unit: str = "", help: str = "") -> Counter:
        return self._get(Counter, name, unit, help)

    def gauge(self, name: str, unit: str = "", help: str = "") -> Gauge:
        return self._get(Gauge, name, unit, help)

    def histogram(self, name: str, unit: str = "", help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, unit, help, buckets=buckets)

    def merge(self, other: "MetricsRegistry") -> None:
        """Adopt every metric from ``other`` (by reference — live series
        keep updating). Name collisions are a hard error for the same
        reason kind collisions are."""
        for name, m in other._metrics.items():
            if name in self._metrics:
                raise ValueError(f"metric {name!r} already registered")
            self._metrics[name] = m

    # ------------------------------------------------------- exports ------

    def snapshot(self) -> dict:
        """Plain dict of every series: counters/gauges as their value
        (bitwise the int the counter holds — no float laundering),
        histograms as their summary dict."""
        out = {}
        for name, m in self._metrics.items():
            out[name] = (m.summary() if isinstance(m, Histogram)
                         else m.value)
        return out

    def to_prometheus(self, prefix: str = "repro_") -> str:
        """Prometheus text exposition (version 0.0.4)."""
        lines = []
        for name, m in self._metrics.items():
            pname = prefix + name.replace("/", "_").replace("-", "_")
            desc = m.help or name
            if m.unit:
                desc += f" ({m.unit})"
            lines.append(f"# HELP {pname} {desc}")
            lines.append(f"# TYPE {pname} {m.kind}")
            if isinstance(m, Histogram):
                acc = 0
                for ub, c in zip(m.buckets, m.bucket_counts):
                    acc += c
                    lines.append(f'{pname}_bucket{{le="{ub}"}} {acc}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pname}_sum {m.total}")
                lines.append(f"{pname}_count {m.count}")
                # summary-style quantile estimates alongside the raw
                # buckets, so dashboards get p50/p95/p99 without a
                # server-side histogram_quantile()
                for q in (0.5, 0.95, 0.99):
                    lines.append(
                        f'{pname}{{quantile="{q}"}} {m.quantile(q)}')
            else:
                lines.append(f"{pname} {m.value}")
        return "\n".join(lines) + "\n"
