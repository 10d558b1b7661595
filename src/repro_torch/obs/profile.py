"""The ECM attribution profiler on the live engine (the port's counterpart
of ``repro.obs.profile``).

Telemetry records what happened; this profiler says where the time went,
the paper's own method. It hangs off the ``Telemetry`` handle
(``Telemetry(profile=True)``) and, per engine phase (``prefill_chunk``,
``decode_step``, ``verify_step``, ``swap_out``, ``swap_in``,
``prefix_promote`` and the first-token ``ops.logit_stats`` pass),
combines three sources:

  (a) counters: the phase's flops, tensor-core (dot) flops and HBM bytes
      from ``CostModel``, a cost function of the model's config, its
      parameter tree and the phase's shapes, cached by (phase, shape
      signature); and the kernels the phase launches, counted once per
      (phase, launch signature) by running that first call under
      ``LaunchCounter``;
  (b) the ECM machine model (``repro_torch.ecm.machines.H100_SXM``)
      pricing the counters into compute / HBM / host-link terms,
      rescaled by the calibration below;
  (c) measured wall seconds per phase (host clock, the device
      synchronized at the phase's end).

``repro_torch.ecm.attribution`` turns the three into the per-phase table.
Exports are JSON, a rendered text report, and Perfetto COUNTER tracks
(phase "C" events) appended to the Chrome trace at export time; they
never enter ``Tracer.events``, so the step-clock determinism contract is
untouched.

How launches are counted: XLA's compiled program, which the reference
reads its counters from, has no analog in eager PyTorch, and what sets a
phase's dispatch time on the card is the number of kernels it launches.
``LaunchCounter`` is a ``TorchDispatchMode`` that counts every aten
operator dispatched with a tensor on the engine's device type, except
views and bare allocations (which launch nothing), and adds the port's
own kernels from ``kernels._build.launches`` (their wrappers launch
through ctypes, below the dispatcher). An operator is counted as one
launch: a few launch two kernels (cuBLAS split-K, a sort), so the count
is close to, not equal to, ``torch.profiler``'s. Counting costs host
time, so it runs once per launch signature and ``reset()`` after a
warm-up wave keeps it out of the attribution.

Calibration: ``calibrate()`` times B2f, the paper's Kahan dot, through
``ops.kahan_dot`` at ``CALIB_ELEMS`` f32 elements (the card's kernel on a
CUDA tensor, its plain twin on the CPU), one call at a time ending in a
synchronize: its ratio to ``CALIBRATION_REF_S`` is the
``host_drift_factor``. Its streaming time (on the card the call's
device time by CUDA events, on the CPU the host time less the dispatch
floor) over the ECM model's is the ``machine_scale``. The dispatch floor
is the host cost of one launch in a stream of launches, which is how a
phase issues its kernels: ``DISPATCH_BURST`` back-to-back elementwise
launches at ``CALIB_DISPATCH_ELEMS`` with one synchronize, per launch.
(B2f's own wrapper costs ~72 us of host time per call on the card, 10x a
bare launch, so it would not stand for the ~2300 aten launches of a
decode step.)
"""

from __future__ import annotations

import json
import statistics
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import device as _device
from repro_torch.ecm import attribution as ecm_attribution
from repro_torch.ecm import hopper
from repro_torch.ecm.machines import H100_SXM
from repro_torch.obs.trace import STEP_TICK_US

# The calibration shape: B2f's 2^24 f32 elements (the shape the kernel
# table times), large enough to stream at the HBM rate on the card.
CALIB_ELEMS = 1 << 24
CALIB_DISPATCH_ELEMS = 1024
DISPATCH_BURST = 64

# Median seconds of one ``ops.kahan_dot`` call at CALIB_ELEMS, host clock
# around the call and a device synchronize, on an NVIDIA H100 80GB HBM3
# at a 700.00 W power limit (``chip_smoke.py``'s [obs] phase).
CALIBRATION_REF_S = 1.3497e-4


@dataclass(frozen=True)
class Calibration:
    """The profiler's measured machine baseline (see module docstring)."""

    ref_s: float              # CALIB_ELEMS Kahan-dot median, this device
    dispatch_s: float         # one launch in a burst (dispatch floor)
    host_drift_factor: float  # ref_s / CALIBRATION_REF_S
    machine_scale: float      # measured stream time / ECM-model time
    elems: int = CALIB_ELEMS

    def to_json(self) -> dict:
        return asdict(self)


def calibrate(reps: int = 5, hw: dict = H100_SXM, *,
              elems: int = CALIB_ELEMS, device=None) -> Calibration:
    """Time the Kahan dot at ``elems`` and the dispatch floor on
    ``device`` (default: the card): medians over ``reps`` after a warm-up.
    ``host_drift_factor`` is meaningful at the default ``elems`` on the
    card only."""
    from repro_torch.kernels import ops
    dev = _device.resolve(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def median_s(fn, burst: int = 1) -> float:
        fn()
        sync()
        ts = []
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            for _ in range(burst):
                fn()
            sync()
            ts.append((time.perf_counter() - t0) / burst)
        return statistics.median(ts)

    x = torch.ones(elems, dtype=torch.float32, device=dev)
    ref_s = median_s(lambda: ops.kahan_dot(x, x))
    small = torch.ones(CALIB_DISPATCH_ELEMS, dtype=torch.float32,
                       device=dev)
    out = torch.empty_like(small)
    dispatch_s = median_s(lambda: torch.add(small, 1.0, out=out),
                          DISPATCH_BURST)
    if cuda:
        ts = []
        for _ in range(max(reps, 1)):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            ops.kahan_dot(x, x)
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e) / 1e3)
        stream_s = statistics.median(ts)
    else:
        stream_s = max(ref_s - dispatch_s, 1e-9)
    model_s = hopper.predicted_runtime_s(hopper.KAHAN_DOT, elems, hw)
    return Calibration(ref_s=ref_s, dispatch_s=dispatch_s,
                       host_drift_factor=ref_s / CALIBRATION_REF_S,
                       machine_scale=stream_s / model_s, elems=elems)


# ---------------------------------------------------------------- costs --

@dataclass(frozen=True)
class PhaseCost:
    flops: float = 0.0        # all flops (dot flops included)
    dot_flops: float = 0.0    # the bf16 tensor-core products
    hbm_bytes: float = 0.0


# Per token and layer: two RMS norms, residual adds, rope, the SwiGLU
# gate (per hidden unit) and the softmax (per score): approximate
# elementwise flop counts of the port's formulation.
_NORM_FLOPS_PER_ELEM = 4.0
_SWIGLU_FLOPS_PER_UNIT = 5.0
_SOFTMAX_FLOPS_PER_SCORE = 5.0
# Per logit row element: the argmax and the two fused ``_logit_stats``
# passes (``hopper.FUSED_DOT_STATS``: 25 per element each)
_LOGIT_FLOPS_PER_ELEM = 1.0 + 2 * hopper.FUSED_DOT_STATS.flops_per_update
# f32 logits are written once and read by the argmax and the two passes
_LOGIT_PASSES = 4
# activation traffic per token and layer, in d_model-wide f32 rows
_ACT_ROWS_PER_LAYER = 12


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


class CostModel:
    """Flops, tensor-core flops and HBM bytes of one engine's phases, from
    its model config, its parameter tree (as held: bf16 or f32) and the
    phase's shapes. Counts what the port's formulation computes: every
    decode row of the batch, the MoE experts' whole capacity buckets, the
    f32 LM head on the CUDA cores (its flops count as elementwise, priced
    at ``f32_flops``), attention on the CUDA cores. Pure arithmetic."""

    def __init__(self, cfg, params, token_bytes: int):
        from repro_torch.models.common import BF16_WEIGHTS
        from repro_torch.models.moe import capacity
        self.cfg = cfg
        self.token_bytes = token_bytes
        self._capacity = capacity
        self.weight_bytes = 0      # every leaf but the embedding table
        self.dot_per_token = 0     # tensor-core products per token (x 2)
        self.f32_per_token = 0     # f32 products per token (x 2)
        self.expert_elems = 0      # sum over MoE layers of E*d*f elements
        self.moe_layers = 0
        for path, t in _leaves(params):
            name = path[-1]
            if name == "embed":
                continue
            self.weight_bytes += t.numel() * t.element_size()
            if t.dim() == 3 and name in ("w_gate_up", "w_down"):
                self.expert_elems += t.numel()
                self.moe_layers += name == "w_down"
            elif t.dim() == 2 and name in BF16_WEIGHTS:
                self.dot_per_token += t.numel()
            elif t.dim() == 2:      # lm_head, MLA's absorbed wk_b / wv_b
                self.f32_per_token += t.numel()
        ff = cfg.d_ff if cfg.moe is None else cfg.moe.d_ff * (
            cfg.moe.top_k + cfg.moe.num_shared)
        self.elem_per_token = cfg.num_layers * (
            2 * _NORM_FLOPS_PER_ELEM * cfg.d_model + 2 * cfg.d_model
            + _SWIGLU_FLOPS_PER_UNIT * ff)
        if cfg.mla is not None:
            m = cfg.mla
            # score over the latent and the rope key, value over the latent
            self.attn_per_ctx = 2 * m.num_heads * (2 * m.kv_lora
                                                   + m.rope_dim)
            self.scores_per_ctx = m.num_heads
        else:
            self.attn_per_ctx = 4 * cfg.num_heads * cfg.head_dim
            self.scores_per_ctx = cfg.num_heads

    def _tokens(self, tokens: int, rows: int, pairs: int,
                kv_read: int) -> PhaseCost:
        """``tokens`` through the layers, ``rows`` logit rows, ``pairs``
        (query, context token) pairs of attention per layer, ``kv_read``
        cached tokens read; ``tokens`` KV entries written."""
        cfg = self.cfg
        v = cfg.vocab_size
        lm_head = cfg.d_model * v
        dot = 2.0 * tokens * self.dot_per_token
        if self.moe_layers:
            # the batched expert FFN runs every expert's capacity bucket
            cap = self._capacity(tokens, cfg.moe)
            dot += 2.0 * cap * self.expert_elems
        f32 = (2.0 * tokens * (self.f32_per_token - lm_head)
               + 2.0 * rows * lm_head)
        attn = cfg.num_layers * pairs * (
            self.attn_per_ctx + _SOFTMAX_FLOPS_PER_SCORE
            * self.scores_per_ctx)
        elem = (tokens * self.elem_per_token + attn + f32
                + rows * v * _LOGIT_FLOPS_PER_ELEM)
        hbm = (self.weight_bytes + tokens * cfg.d_model * 4
               + (kv_read + tokens) * self.token_bytes
               + tokens * cfg.num_layers * _ACT_ROWS_PER_LAYER
               * cfg.d_model * 4
               + rows * v * 4 * _LOGIT_PASSES)
        return PhaseCost(flops=dot + elem, dot_flops=dot, hbm_bytes=hbm)

    def prefill_chunk(self, tokens: int, pos0: int) -> PhaseCost:
        """A chunk of ``tokens`` prompt tokens after ``pos0`` cached ones;
        one logit row (the chunk's last position)."""
        pairs = tokens * pos0 + tokens * (tokens + 1) // 2
        return self._tokens(tokens, 1, pairs, pos0)

    def decode_step(self, rows: int, context: int) -> PhaseCost:
        """One decode step of ``rows`` slots reading ``context`` cached
        tokens in all (their touched blocks)."""
        return self._tokens(rows, rows, context, context)

    def verify_step(self, slots: int, window: int,
                    context: int) -> PhaseCost:
        """One verify step: ``slots`` windows of ``window`` rows over
        ``context`` cached tokens in all."""
        return self._tokens(slots * window, slots * window,
                            window * context, context)

    def logit_stats(self, rows: int) -> PhaseCost:
        """``rows`` logit rows through the argmax and the two fused stats
        passes (the first token's pass, outside the decode step)."""
        v = self.cfg.vocab_size
        return PhaseCost(flops=rows * v * _LOGIT_FLOPS_PER_ELEM,
                         hbm_bytes=rows * v * 4 * (_LOGIT_PASSES - 1))

    @staticmethod
    def copy(nbytes: int) -> PhaseCost:
        """A host swap of ``nbytes``: the device gather or scatter reads
        and writes them once."""
        return PhaseCost(hbm_bytes=2.0 * nbytes)


# --------------------------------------------------------- launch count --

_NO_LAUNCH = frozenset({"empty", "empty_strided", "empty_like",
                        "lift_fresh", "set_", "resize_", "_unsafe_view"})


class LaunchCounter(TorchDispatchMode):
    """Counts the kernels a region launches on ``device_type`` (see the
    module docstring): aten operators with a tensor there, views and
    allocations excluded, plus the port's own kernel launches."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.ops = 0
        self._own = 0

    def __enter__(self):
        from repro_torch.kernels import _build
        self._own = sum(_build.launches.values())
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import _build
        self._own = sum(_build.launches.values()) - self._own
        return super().__exit__(*exc)

    @property
    def count(self) -> int:
        return self.ops + self._own

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (not func.is_view
                and func.overloadpacket.__name__ not in _NO_LAUNCH):
            flat = list(args) + list((kwargs or {}).values())
            flat += list(out) if isinstance(out, (tuple, list)) else [out]
            if any(isinstance(t, torch.Tensor)
                   and t.device.type == self.device_type for t in flat):
                self.ops += 1
        return out


def launch_probe_config(cfg):
    """``cfg`` cut in every width for ``prefill_launches``: d_model 64,
    d_ff and the leading dense FFN 64, vocab 256; MLA's q_lora and
    kv_lora 64, its nope and v dims 16 and 8 heads; the experts' d_ff 64
    and their number max(8, top_k). Widths change no operator of a
    prefill chunk; depth, top_k, the shared experts, the GQA heads, the
    paging geometry and the KV format do, and those are kept."""
    small = cfg.with_(d_model=64, d_ff=64, vocab_size=256,
                      dense_d_ff=min(cfg.dense_d_ff, 64))
    if cfg.mla is not None:
        small = small.with_(mla=cfg.mla._replace(
            num_heads=8, q_lora=64, kv_lora=64, nope_dim=16, v_dim=16))
    if cfg.moe is not None:
        small = small.with_(moe=cfg.moe._replace(
            d_ff=64, num_experts=max(8, cfg.moe.top_k)))
    return small


def count_prefill_launches(cfg, layout, chunk_tokens: int, device) -> int:
    """Kernels one full prefill chunk of ``chunk_tokens`` tokens of
    ``cfg`` launches, counted by ``LaunchCounter``: the chunk runs at
    position 0 over fresh one-slot caches of ``layout``, on ``device``.
    A chunk deeper in a prompt launches as many (the gather reads the
    slot's whole table)."""
    from repro_torch.models import api, paged
    dev = _device.resolve(device)
    params = api.init_params(cfg, device=dev, seed=0)
    caches = api.KVCache(cfg, layout,
                         paged.default_num_blocks(layout, 1)).init(1, dev)
    paged.reset_slot(caches, 0, paged.identity_table(1, layout, dev)[0])
    tokens = torch.zeros((1, chunk_tokens), dtype=torch.int32, device=dev)
    with LaunchCounter(dev.type) as counter:
        api.prefill_chunk_fn(cfg)(params, tokens, caches, 0, 0)
    return counter.count


def prefill_launches(cfg, layout, chunk_tokens: int, device) -> int:
    """``count_prefill_launches`` on ``launch_probe_config(cfg)``: the
    launches of a prefill chunk of ``cfg`` without its weights.
    ``ecm.hopper.predicted_restore_vs_reprefill`` prices re-prefill's
    dispatch with it."""
    return count_prefill_launches(launch_probe_config(cfg), layout,
                                  chunk_tokens, device)


# ------------------------------------------------------------- profiler --

class _PhaseStats:
    """Accumulated counters + wall seconds for one phase."""

    __slots__ = ("calls", "flops", "dot_flops", "hbm_bytes", "host_bytes",
                 "wall_s")

    def __init__(self):
        self.calls = 0
        self.flops = 0.0
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.host_bytes = 0.0
        self.wall_s = 0.0


class _Phase:
    """What the engine tells a running phase: its cost and host bytes."""

    __slots__ = ("cost", "host_bytes")

    def __init__(self):
        self.cost = PhaseCost()
        self.host_bytes = 0


class Profiler:
    """Per-phase cycle accounting on the live engine.

    The engine wraps each phase in ``phase(name, device, launch_key)``
    and sets the phase's ``cost`` (from ``cost()``, cached) and
    ``host_bytes`` inside it; ``record`` takes pre-priced counters.
    ``attribution()`` prices the accumulated counters through
    ``ecm.attribution`` with ``self.calibration`` (measured on first use
    on the card). All of this is off unless ``Telemetry(profile=True)``.
    """

    def __init__(self, hw: dict = H100_SXM):
        self.hw = hw
        self.calibration: Calibration | None = None
        self.phases: dict[str, _PhaseStats] = {}
        self.step = 0
        self._cost_cache: dict[tuple, PhaseCost] = {}
        self._launch_cache: dict[tuple, int] = {}
        # (step, phase, cumulative flops, cumulative hbm_bytes): the
        # Perfetto counter-track samples, kept OUT of Tracer.events
        self._samples: list[tuple] = []

    # ------------------------------------------------------ recording ------

    def set_step(self, step: int) -> None:
        self.step = step

    def calibrate(self, reps: int = 5, **kw) -> Calibration:
        self.calibration = calibrate(reps, self.hw, **kw)
        return self.calibration

    def reset(self) -> None:
        """Drop accumulated phases and samples, KEEP the cost and launch
        caches and the calibration: call it after an untimed warm-up wave
        so launch counting never lands in the attribution."""
        self.phases = {}
        self._samples = []

    def cost(self, phase: str, signature: tuple, fn) -> PhaseCost:
        """``fn()``'s cost, cached by (phase, shape signature)."""
        key = (phase, signature)
        c = self._cost_cache.get(key)
        if c is None:
            c = self._cost_cache[key] = fn()
        return c

    @contextmanager
    def phase(self, name: str, device: torch.device, launch_key=()):
        """Time one call of phase ``name`` (the device synchronized at its
        end) and record it; the first call of each (name, launch_key)
        runs under ``LaunchCounter``, later calls reuse its count."""
        key = (name,) + tuple(launch_key)
        counter = (None if key in self._launch_cache
                   else LaunchCounter(device.type))
        ph = _Phase()
        t0 = time.perf_counter()
        if counter is not None:
            with counter:
                yield ph
            self._launch_cache[key] = counter.count
        else:
            yield ph
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        c = ph.cost
        self.record(name, calls=self._launch_cache[key], flops=c.flops,
                    dot_flops=c.dot_flops, hbm_bytes=c.hbm_bytes,
                    host_bytes=ph.host_bytes,
                    wall_s=time.perf_counter() - t0)

    def record(self, phase: str, *, calls: int = 1, flops: float = 0.0,
               dot_flops: float = 0.0, hbm_bytes: float = 0.0,
               host_bytes: float = 0.0, wall_s: float = 0.0) -> None:
        """Accumulate counters for a phase."""
        ps = self.phases.get(phase)
        if ps is None:
            ps = self.phases[phase] = _PhaseStats()
        ps.calls += calls
        ps.flops += flops
        ps.dot_flops += dot_flops
        ps.hbm_bytes += hbm_bytes
        ps.host_bytes += host_bytes
        ps.wall_s += wall_s
        self._samples.append((self.step, phase, ps.flops, ps.hbm_bytes))

    # ----------------------------------------------------- attribution ----

    def attribution(self) -> list:
        """Per-phase ``PhaseAttribution`` list (calibrates on first use)."""
        cal = self.calibration or self.calibrate()
        return [ecm_attribution.attribute_phase(
                    name, calls=ps.calls, flops=ps.flops,
                    dot_flops=ps.dot_flops, hbm_bytes=ps.hbm_bytes,
                    host_bytes=ps.host_bytes, wall_s=ps.wall_s,
                    machine_scale=cal.machine_scale,
                    dispatch_s=cal.dispatch_s, hw=self.hw)
                for name, ps in self.phases.items()]

    def counter_table(self) -> list:
        """The deterministic identity of the run: per-phase counter rows
        only (no wall time, no calibration); two identical seeded runs
        give identical tables."""
        out = []
        for name in sorted(self.phases):
            ps = self.phases[name]
            out.append((name, ps.calls, round(ps.flops, 3),
                        round(ps.dot_flops, 3), round(ps.hbm_bytes, 3),
                        round(ps.host_bytes, 3)))
        return out

    def render(self) -> str:
        cal = self.calibration or self.calibrate()
        head = (f"calibration: kahan_dot[{cal.elems}] "
                f"{cal.ref_s * 1e6:.1f} us, dispatch "
                f"{cal.dispatch_s * 1e6:.1f} us, host_drift_factor "
                f"{cal.host_drift_factor:.3f}, machine_scale "
                f"{cal.machine_scale:.3f}")
        return head + "\n" + ecm_attribution.render(self.attribution())

    def to_json(self, path=None) -> dict:
        cal = self.calibration or self.calibrate()
        doc = {"calibration": cal.to_json(),
               "phases": [a.to_json() for a in self.attribution()]}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        return doc

    # ------------------------------------------------ Perfetto counters ---

    def counter_events(self) -> list[dict]:
        """Chrome trace COUNTER events (ph "C"): one ``ecm/<phase>`` track
        with cumulative flops and HBM bytes, sampled at each recorded
        phase call on the engine-step ``ts`` axis. Merged into the Chrome
        export by ``Tracer.to_chrome(extra_events=...)``, never stored in
        ``Tracer.events``."""
        return [{"ph": "C", "name": f"ecm/{phase}", "pid": 1,
                 "ts": step * STEP_TICK_US,
                 "args": {"flops": cum_flops, "hbm_bytes": cum_bytes}}
                for step, phase, cum_flops, cum_bytes in self._samples]
