"""Kernel specs for the paper's dot-product variants, per machine (§4; twin
of ``repro.ecm.kernels``).

Instruction counts are per work unit = one cache line per stream, expressed
in machine-SIMD instructions (vectors_per_cl = CL / simd_bytes per stream).
"""

from __future__ import annotations

from repro_torch.ecm.machines import BDW, HSW, KNC, PWR8
from repro_torch.ecm.model import KernelSpec, Machine


def _vecs(m: Machine) -> int:
    return m.cacheline_bytes // m.simd_bytes


def naive_dot_spec(m: Machine) -> KernelSpec:
    """Paper §4.1: naive sdot, SIMD + unrolled (1 FMA per vector)."""
    v = _vecs(m)
    return KernelSpec(
        name="naive_dot", streams=2,
        loads=2 * v, fmas=v,
        flops_per_update=2,
    )


def kahan_dot_avx_spec(m: Machine) -> KernelSpec:
    """Paper §4.2.1 AVX (no-FMA) Kahan: 1 MUL + 4 ADD/SUB per vector."""
    v = _vecs(m)
    return KernelSpec(
        name="kahan_avx", streams=2,
        loads=2 * v, muls=v, adds=4 * v,
        flops_per_update=5,
    )


def kahan_dot_fma_spec(m: Machine) -> KernelSpec:
    """Paper §4.2.1 four-way-unrolled FMA variant.

    vfmsub handles mul+sub, but the FMA's 5-cycle latency chained through the
    partial-sum register caps throughput at 8 cy/CL with 4-way unrolling —
    the port model cannot see latency chains, so T_OL is the paper's
    hand-scheduled value.
    """
    v = _vecs(m)
    return KernelSpec(
        name="kahan_fma", streams=2,
        loads=2 * v, fmas=v, adds=3 * v,
        t_ol_override=8.0,
        flops_per_update=5,
    )


def kahan_dot_fma_opt_spec(m: Machine) -> KernelSpec:
    """Paper §4.2.1 optimized 5-way unrolled 'FMA-abuse' variant:
    16 cy per loop handling 2.5 CLs -> T_OL = 6.4 cy."""
    v = _vecs(m)
    return KernelSpec(
        name="kahan_fma_opt", streams=2,
        loads=2 * v, fmas=2 * v, adds=2 * v,
        t_ol_override=6.4,
        flops_per_update=5,
    )


def kahan_dot_knc_spec(level: str = "Mem") -> KernelSpec:
    """Paper §4.2.2: KNC Kahan with level-specific software prefetch.

    extra non-overlapping slots: +2 cy for L2 prefetch, +4 cy total for the
    memory kernel (L2 + Mem prefetch streams); empirical memory latency
    penalty is 17 cy for this kernel (vs 20 cy for naive).
    """
    v = _vecs(KNC)  # = 1
    return KernelSpec(
        name=f"kahan_knc_{level.lower()}", streams=2,
        loads=2 * v, fmas=v, adds=3 * v,
        extra_nol={"L2": 2.0, "Mem": 4.0},
        mem_latency_penalty_override=17.0,
        flops_per_update=5,
    )


def kahan_dot_pwr8_spec() -> KernelSpec:
    """Paper §4.2.3: PWR8 VSX Kahan: 8 FMA + 24 ADD/SUB + 16 LD per CL."""
    v = _vecs(PWR8)  # = 8
    return KernelSpec(
        name="kahan_pwr8", streams=2,
        loads=2 * v, fmas=v, adds=3 * v,
        flops_per_update=5,
    )


#: (machine, kernel-spec) pairs reproducing every ECM analysis in the paper.
PAPER_ANALYSES = {
    ("HSW", "naive"): (HSW, naive_dot_spec(HSW)),
    ("BDW", "naive"): (BDW, naive_dot_spec(BDW)),
    ("KNC", "naive"): (KNC, naive_dot_spec(KNC)),
    ("PWR8", "naive"): (PWR8, naive_dot_spec(PWR8)),
    ("HSW", "kahan_avx"): (HSW, kahan_dot_avx_spec(HSW)),
    ("BDW", "kahan_avx"): (BDW, kahan_dot_avx_spec(BDW)),
    ("HSW", "kahan_fma"): (HSW, kahan_dot_fma_spec(HSW)),
    ("HSW", "kahan_fma_opt"): (HSW, kahan_dot_fma_opt_spec(HSW)),
    ("BDW", "kahan_fma_opt"): (BDW, kahan_dot_fma_opt_spec(BDW)),
    ("KNC", "kahan"): (KNC, kahan_dot_knc_spec()),
    ("PWR8", "kahan"): (PWR8, kahan_dot_pwr8_spec()),
}
