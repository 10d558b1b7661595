"""SwiGLU feed-forward block (twin of ``repro.models.mlp``)."""

from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.common import ParamSpec


def mlp_schema(d_model: int, d_ff: int) -> dict:
    return {
        # fused gate+up: one matmul, split on the hidden axis
        "w_gate_up": ParamSpec((d_model, 2 * d_ff), init="fan_in"),
        "w_down": ParamSpec((d_ff, d_model), init="fan_in"),
    }


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate_up = common.dense(x, p["w_gate_up"])
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    return common.dense(common.swiglu(gate, up), p["w_down"])
