"""Dense feed-forward blocks, SwiGLU (fused gate/up) and GELU (twin of
``repro.models.mlp``)."""

from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.common import ParamSpec


def mlp_schema(d_model: int, d_ff: int, act: str = "swiglu") -> dict:
    if act == "swiglu":
        return {
            # fused gate+up: one matmul, split on the hidden axis
            "w_gate_up": ParamSpec((d_model, 2 * d_ff), ("embed", "mlp"),
                                   init="fan_in"),
            "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed"),
                                init="fan_in"),
        }
    return {"w_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), init="fan_in"),
            "b_up": ParamSpec((d_ff,), ("mlp",), init="zeros"),
            "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed"),
                                init="fan_in"),
            "b_down": ParamSpec((d_model,), ("embed",), init="zeros")}


def _split_gate_up(w: torch.Tensor) -> bool:
    """Whether a fused gate/up weight is a DTensor whose columns one
    mesh dim splits in slices that each half divides into."""
    if type(w) is torch.Tensor:
        return False
    from repro_torch.distributed.sharding import column_dims
    dims = column_dims(w)
    return len(dims) == 1 and (w.shape[-1] // 2) % w.device_mesh.size(
        dims[0]) == 0


def _swiglu_split(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The SwiGLU MLP with its hidden dim kept split over the mesh: the
    fused product runs on the weight relaid per shard ([gate_r | up_r] on
    shard r, ``sharding.gate_up_per_shard``), each rank applies SwiGLU to
    its own gate and up columns, and ``w_down``'s rows of the same slice
    give a partial sum that ``common.dense`` reduces. No rank holds the
    [.., 2 d_ff] product or the whole SwiGLU pair. The same products, in
    the same K order, as the fused form's."""
    from repro_torch.distributed.sharding import gate_up_per_shard, per_shard
    gate_up = common.dense(x, gate_up_per_shard(p["w_gate_up"]))
    dims = {i: i for i in range(gate_up.ndim)}
    h = per_shard(lambda gu: common.swiglu(*torch.chunk(gu, 2, dim=-1)),
                  (gate_up,), (dims,), (dims,))
    return common.dense(h, p["w_down"])


def mlp_forward(p: dict, x: torch.Tensor, act: str = "swiglu"
                ) -> torch.Tensor:
    if act == "swiglu":
        if _split_gate_up(p["w_gate_up"]):
            return _swiglu_split(p, x)
        gate_up = common.dense(x, p["w_gate_up"])
        gate, up = torch.chunk(gate_up, 2, dim=-1)
        return common.dense(common.swiglu(gate, up), p["w_down"])
    h = common.gelu(common.dense(x, p["w_up"], p["b_up"]).to(torch.float32))
    return common.dense(h.to(x.dtype), p["w_down"], p["b_down"])
