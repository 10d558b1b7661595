"""Architecture registry of the port: the ten configs of the reference's
registry, one module each, plus the reduced same-family variants the CPU
tests and the serving CLI use (twin of ``repro.configs.registry``)."""

from __future__ import annotations

from repro_torch.configs import (deepseek_v2_236b, llava_next_mistral_7b,
                                 mamba2_780m, olmoe_1b_7b, qwen1_5_05b,
                                 qwen1_5_110b, qwen1_5_32b, stablelm_3b,
                                 whisper_tiny, zamba2_1_2b)
from repro_torch.models.config import (EncDecConfig, HybridConfig,
                                       ModelConfig, VLMConfig)
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssd import SSMConfig

_MODULES = [mamba2_780m, stablelm_3b, qwen1_5_110b, qwen1_5_32b, qwen1_5_05b,
            llava_next_mistral_7b, olmoe_1b_7b, deepseek_v2_236b,
            whisper_tiny, zamba2_1_2b]

REGISTRY: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests and the serving CLI, every
    branch of ``repro.configs.reduced``."""
    kw: dict = dict(num_layers=2, d_model=64, vocab_size=256, q_chunk=32,
                    kv_chunk=32, remat=False)
    if cfg.family in ("dense", "vlm"):
        kw.update(num_heads=4,
                  num_kv_heads=4 if cfg.num_kv_heads == cfg.num_heads else 2,
                  head_dim=16, d_ff=128)
    if cfg.family == "vlm":
        kw.update(vlm=VLMConfig(vision_dim=32, num_patches=8))
    if cfg.family == "moe":
        if cfg.mla is not None:
            kw.update(mla=MLAConfig(num_heads=4, q_lora=32, kv_lora=16,
                                    nope_dim=16, rope_dim=8, v_dim=16,
                                    q_chunk=32, kv_chunk=32),
                      moe=MoEConfig(num_experts=8, top_k=2, d_ff=32,
                                    num_shared=cfg.moe.num_shared),
                      first_k_dense=cfg.first_k_dense, dense_d_ff=128)
        else:
            kw.update(num_heads=4, num_kv_heads=4, head_dim=16,
                      moe=MoEConfig(num_experts=8, top_k=2, d_ff=32))
    if cfg.family == "ssm":
        kw.update(ssm=SSMConfig(d_inner=128, state_dim=16, head_dim=32,
                                chunk=32))
    if cfg.family == "hybrid":
        kw.update(num_layers=5,
                  ssm=SSMConfig(d_inner=128, state_dim=16, head_dim=32,
                                chunk=32),
                  hybrid=HybridConfig(segment_len=2, shared_d_ff=128,
                                      lora_rank=8, num_attn_heads=4,
                                      num_kv_heads=4))
    if cfg.family == "audio":
        kw.update(num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                  encdec=EncDecConfig(enc_layers=2, enc_seq=64))
    return cfg.with_(**kw)
