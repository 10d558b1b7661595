"""Per-request tracing on the engine-step clock (twin of
``repro.obs.trace``; plain Python, the same events and exports).

The serving engine's natural clock is its own step counter — one tick
per ``DecodeEngine.step()`` — and every scheduling decision (admission,
chunked prefill, preemption, quarantine, retirement) happens at a tick.
Recording events on that clock instead of wall time makes a trace
DETERMINISTIC: the same seed and the same fault-injector log reproduce
the identical event sequence bit-for-bit across hosts, kv_dtypes and
reruns (tests/test_torch_obs.py), which is what lets the perf trajectory
separate code regressions (the step-clock sequence moved) from host
drift (only wall time moved). Wall-clock timestamps ride along as an
OPTIONAL annotation (``Telemetry(wall_clock=True)``) and never enter
the determinism contract.

Events are spans or instants on per-request tracks:

    queued    B/E   submit .. admission (args: prompt/new-token budget)
    prefill   B/E   admission .. first token (args: prefix hit, blocks)
    decode    B/E   first token .. retire/preempt/terminal
    preempted B/E   swap-out .. restore
    instants        prefill_chunk, decode_step, verify_step, swap_out,
                    swap_in, prefix_hit, prefix_evict, guard_trip,
                    fault_injected, failover_retry, stall, retired,
                    cancelled, expired, quarantined

Two export formats: JSONL (one event per line — grep/jq-able, the raw
record of the step clock) and the Chrome trace-event JSON that Perfetto
and chrome://tracing load directly — each request renders as its own
track with its lifecycle spans, with engine-wide events (decode steps,
injector firings) on track 0. The Chrome ``ts`` axis is the step clock
scaled by 1000 (one engine step == 1 "ms"), so span widths read as
engine steps, not seconds.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

# Chrome trace-event phase codes used here: span begin / span end /
# instant. Everything else (counters, metadata) is synthesized at export.
_PHASES = ("B", "E", "i")

# µs per engine step on the Chrome ``ts`` axis: one step renders as one
# millisecond so Perfetto's zoom levels land on step boundaries.
STEP_TICK_US = 1000


@dataclass
class TraceEvent:
    """One event on the engine-step clock.

    ``step`` is the monotonic engine step at which the event happened;
    ``seq`` orders events within a step (assignment order — itself
    deterministic). ``rid`` is the request track (None = engine-wide).
    ``wall`` is the optional wall-clock annotation (perf_counter
    seconds); it is excluded from ``key()`` so determinism checks never
    see it.
    """

    step: int
    seq: int
    name: str
    ph: str
    rid: int | None = None
    args: dict = field(default_factory=dict)
    wall: float | None = None

    def key(self) -> tuple:
        """The deterministic identity of this event: everything except
        the wall-clock annotation. Two runs with the same seed and the
        same fault log must produce identical key sequences."""
        return (self.step, self.seq, self.name, self.ph, self.rid,
                tuple(sorted(self.args.items())))

    def to_json(self) -> dict:
        d = {"step": self.step, "seq": self.seq, "name": self.name,
             "ph": self.ph, "rid": self.rid, "args": self.args}
        if self.wall is not None:
            d["wall"] = self.wall
        return d


class Tracer:
    """Append-only event recorder on the engine-step clock.

    The engine advances ``self.step`` once per ``DecodeEngine.step()``;
    components that know their own step (the fault injector) may stamp
    it explicitly. Events carry only counts (tokens, blocks, steps) in
    ``args`` — never bytes or logit values, which vary across kv_dtypes
    and would break the cross-dtype determinism contract.
    """

    def __init__(self, wall_clock: bool = False):
        self.wall_clock = wall_clock
        self.events: list[TraceEvent] = []
        self.step = 0
        self._seq = 0

    def __len__(self) -> int:
        return len(self.events)

    def set_step(self, step: int) -> None:
        self.step = step

    def _emit(self, name: str, ph: str, rid: int | None,
              step: int | None, args: dict) -> TraceEvent:
        assert ph in _PHASES, ph
        ev = TraceEvent(self.step if step is None else step, self._seq,
                        name, ph, rid, args,
                        time.perf_counter() if self.wall_clock else None)
        self._seq += 1
        self.events.append(ev)
        return ev

    def begin(self, name: str, rid: int | None = None, *,
              step: int | None = None, **args) -> TraceEvent:
        """Open a span on ``rid``'s track."""
        return self._emit(name, "B", rid, step, args)

    def end(self, name: str, rid: int | None = None, *,
            step: int | None = None, **args) -> TraceEvent:
        """Close the matching span on ``rid``'s track."""
        return self._emit(name, "E", rid, step, args)

    def instant(self, name: str, rid: int | None = None, *,
                step: int | None = None, **args) -> TraceEvent:
        return self._emit(name, "i", rid, step, args)

    # ------------------------------------------------------- queries ------

    def key_sequence(self) -> list[tuple]:
        """The deterministic identity sequence (see TraceEvent.key)."""
        return [ev.key() for ev in self.events]

    def select(self, name: str, rid: int | None = ...) -> list[TraceEvent]:
        """Events called ``name`` (optionally on one request track)."""
        return [ev for ev in self.events
                if ev.name == name and (rid is ... or ev.rid == rid)]

    # ------------------------------------------------------- exports ------

    def to_jsonl(self, path) -> int:
        """One event per line; returns the event count."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev.to_json()) + "\n")
        return len(self.events)

    def chrome_events(self) -> list[dict]:
        """Chrome trace-event dicts (the ``traceEvents`` list)."""
        out = []
        tracks = sorted({ev.rid for ev in self.events
                         if ev.rid is not None})
        # Track 0 is the engine; each request renders as its own named
        # thread so Perfetto shows one lifecycle lane per request.
        out.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": 0,
                    "args": {"name": "engine"}})
        for rid in tracks:
            out.append({"ph": "M", "name": "thread_name", "pid": 1,
                        "tid": rid + 1,
                        "args": {"name": f"request {rid}"}})
        intra: dict[int, int] = {}      # per-step micro-offset: events in
        for ev in self.events:          # one step keep their order on ts
            off = intra.get(ev.step, 0)
            intra[ev.step] = off + 1
            d = {"ph": ev.ph, "name": ev.name, "pid": 1,
                 "tid": 0 if ev.rid is None else ev.rid + 1,
                 "ts": ev.step * STEP_TICK_US + min(off, STEP_TICK_US - 1),
                 "args": dict(ev.args, step=ev.step)}
            if ev.ph == "i":
                d["s"] = "t"            # instant scoped to its thread
            if ev.wall is not None:
                d["args"]["wall_s"] = ev.wall
            out.append(d)
        return out

    def to_chrome(self, path, extra_events: list | None = None) -> int:
        """Perfetto/chrome://tracing-loadable JSON; returns event count.

        ``extra_events`` are pre-built Chrome event dicts appended at
        export time — the profiler's ECM counter tracks (ph "C") ride
        along this way so they never enter ``self.events`` and the
        step-clock determinism contract stays purely span/instant."""
        doc = {"displayTimeUnit": "ms",
               "otherData": {"clock": "engine-step",
                             "step_tick_us": STEP_TICK_US},
               "traceEvents": self.chrome_events() + list(extra_events or ())}
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(self.events)
