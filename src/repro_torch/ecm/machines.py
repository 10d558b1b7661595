"""Machine descriptions: the paper's four testbeds (Table I) and the card
the port runs on (twin of ``repro.ecm.machines``).

The four CPU machines reproduce the paper's inputs exactly (the same
``Machine`` objects as the reference); tests/test_torch_ecm.py asserts
the paper's published predictions against them. Latency penalties T_p
are the paper's empirical values.

``H100_SXM`` is the card (NVIDIA H100 80GB HBM3, SXM), a plain dict that
``repro_torch.ecm.hopper`` and ``repro_torch.ecm.attribution`` price
with and the serving engine's promote gate reads. Every figure is the
data sheet's (dense rates, at the card's full 700 W power limit) or was
measured on the card:

- ``peak_flops``: 989 TFLOP/s, the bf16 tensor cores. The served path's
  dense and MoE products are bf16 x bf16 tensor-core GEMMs with an f32
  result (``models.common.dense``, ``models.moe._expert_matmul``), so a
  re-prefill runs at this rate;
- ``f32_flops``: 67 TFLOP/s, f32 on the CUDA cores outside the tensor
  cores: the elementwise work (norms, softmax, the compensated
  reductions) and the f32 LM head (TF32 off, ``device.set_numerics``);
- ``hbm_bw``: 3.35 TB/s;
- ``host_link_bw``: the pinned host -> device copy rate in bytes/s that
  ``chip_smoke.py`` measures (its ``[preempt]`` phase: one contiguous
  256 MiB pinned copy, median of 10 by CUDA events): 49.704 GB/s on an
  NVIDIA H100 80GB HBM3 at a 700.00 W power limit (device -> host
  50.638 GB/s). A restore moves host -> device, so that direction
  prices it.
"""

from __future__ import annotations

from repro_torch.ecm.model import CacheLevel, Machine

# --- Intel Haswell-EP (E5-2695 v3), CoD mode: 7 cores / memory domain ------
HSW = Machine(
    name="HSW",
    freq_ghz=2.3,
    cacheline_bytes=64,
    simd_bytes=32,
    cores=7,                       # per CoD memory domain (14/chip)
    levels=(
        CacheLevel("L2", 64.0),
        CacheLevel("L3", 32.0, latency_penalty_cy=1.0),
    ),
    mem_bw_gbs=32.0,               # measured, per memory domain
    mem_latency_penalty_cy=1.0,
    load_ports=2, store_ports=1, add_ports=1, mul_ports=2, fma_ports=2,
    overlap="intel",
)

# --- Intel Broadwell-EP (pre-release 22-core), CoD mode --------------------
BDW = Machine(
    name="BDW",
    freq_ghz=2.1,
    cacheline_bytes=64,
    simd_bytes=32,
    cores=11,
    levels=(
        CacheLevel("L2", 64.0),
        CacheLevel("L3", 32.0, latency_penalty_cy=5.0),
    ),
    mem_bw_gbs=32.3,
    mem_latency_penalty_cy=5.0,
    load_ports=2, store_ports=1, add_ports=1, mul_ports=2, fma_ports=2,
    overlap="intel",
)

# --- Intel Xeon Phi 5110P "Knights Corner" ----------------------------------
KNC = Machine(
    name="KNC",
    freq_ghz=1.05,
    cacheline_bytes=64,
    simd_bytes=64,
    cores=60,
    levels=(
        CacheLevel("L2", 32.0),    # L1<->L2, 32 B/cy
    ),
    mem_bw_gbs=175.0,
    mem_latency_penalty_cy=20.0,   # ring interconnect (naive-dot kernel)
    load_ports=1, store_ports=1, add_ports=1, mul_ports=1, fma_ports=1,
    shared_arith_ports=1.0,        # single vector U-pipe
    overlap="knc",
)

# --- IBM POWER8 (S822LC, 4 Centaur) -----------------------------------------
PWR8 = Machine(
    name="PWR8",
    freq_ghz=2.9,                  # paper uses 2.9 in the transfer arithmetic
    cacheline_bytes=128,
    simd_bytes=16,
    cores=10,
    levels=(
        CacheLevel("L2", 64.0),    # L1<->L2 (multi-ported L1)
        CacheLevel("L3", 32.0),    # L2<->L3, no penalty (core-private L3)
    ),
    mem_bw_gbs=73.6,               # Centaur interconnect, measured
    mem_latency_penalty_cy=0.0,
    load_ports=2, store_ports=2, add_ports=2, mul_ports=2, fma_ports=2,
    shared_arith_ports=2.0,        # two generic VSX pipes
    overlap="full",
)

PAPER_MACHINES = {"HSW": HSW, "BDW": BDW, "KNC": KNC, "PWR8": PWR8}


H100_SXM = {
    "name": "H100 SXM",
    "host_link_bw": 49.704e9,
    "hbm_bw": 3.35e12,
    "peak_flops": 989e12,
    "f32_flops": 67e12,
}
