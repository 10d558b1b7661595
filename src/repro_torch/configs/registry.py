"""Architecture registry of the port: the configs it serves, plus the
reduced same-family variants the CPU tests use."""

from __future__ import annotations

from repro_torch.configs import qwen1_5_05b
from repro_torch.models.config import ModelConfig

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen1_5_05b,)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny dense config for CPU tests (``repro.configs.reduced``'s dense
    branch)."""
    return cfg.with_(
        num_layers=2, d_model=64, vocab_size=256, q_chunk=32, kv_chunk=32,
        num_heads=4,
        num_kv_heads=4 if cfg.num_kv_heads == cfg.num_heads else 2,
        head_dim=16, d_ff=128)
