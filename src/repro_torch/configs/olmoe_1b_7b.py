"""olmoe-1b-7b — MoE [arXiv:2409.02060]. 64 experts, top-8.

16L d_model=2048 16H (kv=16) per-expert d_ff=1024 vocab=50304.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff=1024),
)
