"""The ECM (Execution-Cache-Memory) performance model, executable (paper §2;
twin of ``repro.ecm.model``, plain Python).

Predicts single-core cycles per cache-line of work for a streaming loop
kernel, per memory-hierarchy level, plus multicore saturation:

    T_ECM(level) = max(T_OL, T_nOL(level) + Σ_{l<=level} (T_l + T_p,l))
    n_S          = ceil(T_ECM(Mem) / T_Mem)
    P_sat        = f · W_CL / T_Mem

The overlap semantics are machine-specific (paper §2, §4):
  * Intel Xeon (HSW/BDW): cycles with L1<->register traffic (loads/stores) are
    non-overlapping with any cache/memory transfer → T_nOL = load/store cycles.
  * KNC: vector arithmetic retires on the U-pipe (T_OL); loads can pair with
    arithmetic; *software prefetch* instructions consume extra non-overlapping
    issue slots that grow with the distance of the source level.
  * POWER8: fully overlapping L1 (multi-ported) → T_nOL = 0; loads compete
    with arithmetic for retirement, so T_OL = max(load cycles, arith cycles).

All times are cycles per work-unit = the iterations covering one cache line
per stream ("one CL's worth of work", n_it = CL/elem_bytes).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def _round1(x: float) -> float:
    """The paper reports per-CL transfer times rounded to 0.1 cy; matching
    its arithmetic requires rounding before multiplying by stream count."""
    return round(x, 1)


@dataclass(frozen=True)
class CacheLevel:
    """One inter-level transfer path (e.g. L1<->L2)."""
    name: str
    bandwidth_B_per_cy: float           # documented transfer bandwidth
    latency_penalty_cy: float = 0.0     # empirical T_p applied at this level


@dataclass(frozen=True)
class Machine:
    """Machine description (paper Table I)."""
    name: str
    freq_ghz: float
    cacheline_bytes: int
    simd_bytes: int
    cores: int                           # cores per chip (or memory domain)
    levels: tuple[CacheLevel, ...]       # ordered L1L2, L2L3, ... (no memory)
    mem_bw_gbs: float                    # measured sustained (per domain)
    mem_latency_penalty_cy: float = 0.0
    load_ports: float = 2.0              # loads retire-able per cycle
    store_ports: float = 1.0
    add_ports: float = 1.0               # ADD/SUB pipes
    mul_ports: float = 2.0
    fma_ports: float = 2.0
    # KNC's single U-pipe / PWR8's two generic VSX units execute *all* vector
    # arithmetic; when set, arithmetic time is (adds+muls+fmas)/shared ports.
    shared_arith_ports: float | None = None
    overlap: str = "intel"               # "intel" | "knc" | "full"

    def mem_cy_per_cl(self) -> float:
        """Per-CL transfer time from sustained memory bandwidth (paper §2)."""
        return _round1(self.cacheline_bytes * self.freq_ghz / self.mem_bw_gbs)


@dataclass(frozen=True)
class KernelSpec:
    """Per-work-unit instruction counts of a streaming loop kernel.

    Counts are *SIMD instructions* per one-CL-per-stream work unit (already
    multiplied out for the machine's SIMD width). ``t_ol_override`` encodes
    hand-scheduled results the port model cannot see (e.g. the paper's 5-way
    unrolled FMA-abuse variant: 16 cy / 2.5 CL = 6.4 cy).
    """
    name: str
    streams: int                 # distinct load streams (dot: a and b -> 2)
    loads: int
    stores: int = 0
    adds: int = 0
    muls: int = 0
    fmas: int = 0
    t_ol_override: float | None = None
    # extra non-overlapping issue slots per source level, keyed by level name
    # (KNC software prefetch, paper §4.2.2)
    extra_nol: dict = field(default_factory=dict)
    # empirical memory latency penalty differs per kernel on KNC (paper:
    # 20 cy naive, 17 cy Kahan)
    mem_latency_penalty_override: float | None = None
    flops_per_update: int = 2    # work metric bookkeeping (naive dot: 1 FMA)


@dataclass(frozen=True)
class ECMPrediction:
    machine: str
    kernel: str
    t_ol: float
    t_nol: float
    t_levels: tuple[float, ...]       # per-level transfer incl. penalty
    t_ecm: tuple[float, ...]          # prediction per level (L1, L2, ..., Mem)
    level_names: tuple[str, ...]
    n_saturation: int
    t_mem_transfer: float             # bottleneck-only term (no penalty)
    updates_per_cl: int
    freq_ghz: float

    def performance_gups(self) -> tuple[float, ...]:
        """Per-level performance in GUP/s (paper Eqs. (1)-(3))."""
        return tuple(self.updates_per_cl * self.freq_ghz / t for t in self.t_ecm)

    def saturated_gups(self) -> float:
        """P_sat = f · W_CL / T_Mem (paper §2)."""
        return self.freq_ghz * self.updates_per_cl / self.t_mem_transfer

    def shorthand(self) -> str:
        inner = " | ".join(f"{t:g}" for t in self.t_ecm)
        return "{ " + inner + " } cy"


def _core_times(m: Machine, k: KernelSpec) -> tuple[float, float]:
    """(T_OL, T_nOL) from the port model + machine overlap semantics."""
    t_ld = k.loads / m.load_ports
    t_st = k.stores / m.store_ports
    if m.shared_arith_ports is not None:
        # KNC U-pipe / PWR8 VSX: all vector arithmetic shares the same units
        t_arith = (k.adds + k.muls + k.fmas) / m.shared_arith_ports
    else:
        # Intel: dedicated ADD pipe, separate MUL/FMA ports
        t_arith = max(k.adds / m.add_ports,
                      k.muls / m.mul_ports,
                      k.fmas / m.fma_ports)
    if m.overlap == "full":          # POWER8
        t_ol = max(t_ld + t_st, t_arith)
        t_nol = 0.0
    elif m.overlap == "knc":
        # vector arith retires on the U-pipe only; loads pair with arith
        t_ol = t_arith
        t_nol = t_ld + t_st
    else:                            # intel
        t_ol = t_arith
        t_nol = t_ld + t_st
    if k.t_ol_override is not None:
        t_ol = k.t_ol_override
    return t_ol, t_nol


def predict(m: Machine, k: KernelSpec) -> ECMPrediction:
    """Full ECM prediction {T_core | T_L2 | ... | T_Mem} for kernel on machine."""
    t_ol, t_nol_base = _core_times(m, k)

    # per-level transfer contributions (streams CLs each)
    level_names = []
    t_levels = []
    for lvl in m.levels:
        t = k.streams * m.cacheline_bytes / lvl.bandwidth_B_per_cy
        t_levels.append(t + lvl.latency_penalty_cy)
        level_names.append(lvl.name)
    t_mem = k.streams * m.mem_cy_per_cl()
    mem_penalty = (m.mem_latency_penalty_cy
                   if k.mem_latency_penalty_override is None
                   else k.mem_latency_penalty_override)
    t_levels.append(t_mem + mem_penalty)
    level_names.append("Mem")

    # prediction per data-source level
    preds = []
    # L1-resident: no transfers
    t_nol = t_nol_base + k.extra_nol.get("L1", 0.0)
    preds.append(max(t_ol, t_nol))
    for i in range(len(t_levels)):
        t_nol = t_nol_base + k.extra_nol.get(level_names[i], 0.0)
        t_data = sum(t_levels[: i + 1])
        preds.append(max(t_ol, t_nol + t_data))

    updates_per_cl = m.cacheline_bytes // 4  # SP elements per CL
    n_sat = math.ceil(preds[-1] / t_mem)
    return ECMPrediction(
        machine=m.name, kernel=k.name, t_ol=t_ol, t_nol=t_nol_base,
        t_levels=tuple(t_levels), t_ecm=tuple(preds),
        level_names=("L1",) + tuple(level_names),
        n_saturation=n_sat, t_mem_transfer=t_mem,
        updates_per_cl=updates_per_cl, freq_ghz=m.freq_ghz,
    )


def scaling_curve(pred: ECMPrediction, max_cores: int) -> list[float]:
    """Multicore in-memory scaling under the ECM linear-until-saturation
    assumption (paper Fig. 1): P(n) = min(n · P_1, P_sat)."""
    p1 = pred.updates_per_cl * pred.freq_ghz / pred.t_ecm[-1]
    psat = pred.saturated_gups()
    return [min(n * p1, psat) for n in range(1, max_cores + 1)]
