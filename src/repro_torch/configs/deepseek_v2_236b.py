"""deepseek-v2-236b — MoE + MLA [arXiv:2405.04434].

60L d_model=5120, MLA (kv_lora=512, rope_dim=64, 128 heads), MoE with
2 shared + 160 routed experts top-6, per-expert d_ff=1536, first layer
dense (d_ff=12288), vocab=102400.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", num_layers=60, d_model=5120,
    vocab_size=102400,
    mla=MLAConfig(num_heads=128, q_lora=1536, kv_lora=512, nope_dim=128,
                  rope_dim=64, v_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff=1536, num_shared=2),
    first_k_dense=1, dense_d_ff=12288,
)
