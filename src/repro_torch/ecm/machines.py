"""Machine figures the port prices its decisions with (twin of
``repro.ecm.machines``, in part: only what the serving engine reads).

``H100_SXM`` is the card the port runs on (NVIDIA H100 80GB HBM3, SXM):

- ``host_link_bw``: the pinned host -> device copy rate in bytes/s that
  ``chip_smoke.py`` measures (its ``[preempt]`` phase: one contiguous
  256 MiB pinned copy, median of 10 by CUDA events): 49.704 GB/s on an
  NVIDIA H100 80GB HBM3 at a 700.00 W power limit (device -> host
  50.638 GB/s). A restore moves host -> device, so that direction
  prices it;
- ``hbm_bw``: the data sheet's 3.35 TB/s;
- ``peak_flops``: the rate of the GEMMs the port's prefill runs today.
  ``models.common.dense`` widens bf16-rounded operands to f32 and
  ``device.set_numerics`` turns TF32 off, so that is f32 on the CUDA
  cores, the data sheet's 67 TFLOP/s, not the bf16 tensor cores' 989.
  When prefill moves to bf16 tensor-core GEMMs this figure moves with it.
"""

H100_SXM = {
    "name": "H100 SXM",
    "host_link_bw": 49.704e9,
    "hbm_bw": 3.35e12,
    "peak_flops": 67e12,
}
