"""Architecture registry of the port: the configs it serves, plus the
reduced same-family variants the CPU tests use."""

from __future__ import annotations

from repro_torch.configs import deepseek_v2_236b, qwen1_5_05b
from repro_torch.models.config import ModelConfig
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen1_5_05b, deepseek_v2_236b)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests (the dense and moe branches
    of ``repro.configs.reduced``)."""
    kw: dict = dict(num_layers=2, d_model=64, vocab_size=256, q_chunk=32,
                    kv_chunk=32)
    if cfg.family == "dense":
        kw.update(num_heads=4,
                  num_kv_heads=4 if cfg.num_kv_heads == cfg.num_heads else 2,
                  head_dim=16, d_ff=128)
    if cfg.family == "moe":
        if cfg.mla is not None:
            kw.update(mla=MLAConfig(num_heads=4, q_lora=32, kv_lora=16,
                                    nope_dim=16, rope_dim=8, v_dim=16),
                      moe=MoEConfig(num_experts=8, top_k=2, d_ff=32,
                                    num_shared=cfg.moe.num_shared),
                      first_k_dense=cfg.first_k_dense, dense_d_ff=128)
        else:
            kw.update(num_heads=4, num_kv_heads=4, head_dim=16,
                      moe=MoEConfig(num_experts=8, top_k=2, d_ff=32))
    return cfg.with_(**kw)
