"""Three-term roofline of one traced step on H100 SXM cards (the role of
``repro.ecm.tpu_roofline``).

From ``step_cost.StepCost``'s per-device counts:

    compute    = dot flops / peak_flops + elementwise flops / f32_flops
    memory     = bytes / hbm_bw
    collective = sum over mesh axes of the axis's ring-weighted bytes
                 over the axis's link

A collective's group runs over NVLink (``nvlink_bw``) when its ranks lie
within one host of ``gpus_per_host`` GPUs, else over the hosts' network
(``net_bw``, one NIC per GPU): the ring's slowest hop sets its rate.
Meshes are row-major over the ranks, so on 8-GPU hosts the production
mesh's inner "model" axis (16) spans two hosts and is priced at the
network's rate, as are "data" and "pod". All rates are ``H100_SXM``'s
data-sheet figures at the card's 700 W limit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.ecm.machines import H100_SXM


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                 # the step's flops per device
    hlo_bytes: float                 # the step's bytes per device
    collective_bytes: float          # ring-weighted, per device
    t_compute_s: float
    t_memory_s: float
    t_collective_s: float
    model_flops: float               # GLOBAL 6·N(_active)·D per step
    bytes_per_chip: float            # arguments + peak temporaries
    collectives: dict = field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute_s, "memory": self.t_memory_s,
                 "collective": self.t_collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        """(model flops per device) / (traced flops per device)."""
        if not self.hlo_flops:
            return 0.0
        return self.model_flops / self.chips / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time over the dominant term's time."""
        t_useful = self.model_flops / (self.chips * H100_SXM["peak_flops"])
        t_bound = max(self.t_compute_s, self.t_memory_s, self.t_collective_s)
        return t_useful / t_bound if t_bound else 0.0


def within_host(mesh_shape: dict, axis: str, hw: dict = H100_SXM) -> bool:
    """Whether every group along ``axis`` of a row-major mesh ({axis:
    size}, outermost first) lies within one host."""
    names = list(mesh_shape)
    i = names.index(axis)
    stride = math.prod(mesh_shape[a] for a in names[i + 1:])
    span = stride * mesh_shape[axis]
    per_host = hw["gpus_per_host"]
    return span <= per_host and per_host % span == 0


def axis_bw(mesh_shape: dict, axis: str, hw: dict = H100_SXM) -> float:
    """Bytes/s a device moves in a collective along ``axis``."""
    return hw["nvlink_bw"] if within_host(mesh_shape, axis, hw) \
        else hw["net_bw"]


def roofline_from_cost(arch: str, shape: str, mesh: str, chips: int,
                       cost, model_flops: float, bytes_per_chip: float,
                       mesh_shape: dict, hw: dict = H100_SXM
                       ) -> RooflineReport:
    """Three-term report from a ``step_cost.StepCost`` on ``mesh_shape``
    ({axis: size}); a collective on an axis the mesh does not name is
    priced at the network's rate."""
    t_coll = sum(b / (axis_bw(mesh_shape, a, hw) if a in mesh_shape
                      else hw["net_bw"])
                 for a, b in cost.axis_bytes.items())
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes_accessed,
        collective_bytes=cost.weighted_collective_bytes,
        t_compute_s=cost.dot_flops / hw["peak_flops"]
        + cost.elementwise_flops / hw["f32_flops"],
        t_memory_s=cost.bytes_accessed / hw["hbm_bw"],
        t_collective_s=t_coll,
        model_flops=model_flops,
        bytes_per_chip=bytes_per_chip,
        collectives={k: {"bytes": v,
                         "count": cost.collective_count.get(k, 0)}
                     for k, v in cost.collective_bytes.items()},
    )
