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
            "w_gate_up": ParamSpec((d_model, 2 * d_ff), init="fan_in"),
            "w_down": ParamSpec((d_ff, d_model), init="fan_in"),
        }
    return {"w_up": ParamSpec((d_model, d_ff), init="fan_in"),
            "b_up": ParamSpec((d_ff,), init="zeros"),
            "w_down": ParamSpec((d_ff, d_model), init="fan_in"),
            "b_down": ParamSpec((d_model,), init="zeros")}


def mlp_forward(p: dict, x: torch.Tensor, act: str = "swiglu"
                ) -> torch.Tensor:
    if act == "swiglu":
        gate_up = common.dense(x, p["w_gate_up"])
        gate, up = torch.chunk(gate_up, 2, dim=-1)
        return common.dense(common.swiglu(gate, up), p["w_down"])
    h = common.gelu(common.dense(x, p["w_up"], p["b_up"]).to(torch.float32))
    return common.dense(h.to(x.dtype), p["w_down"], p["b_down"])
