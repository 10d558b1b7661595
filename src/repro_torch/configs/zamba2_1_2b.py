"""zamba2-1.2b — hybrid Mamba2 + shared attention [arXiv:2411.15242].

38 SSM layers d_model=2048 ssm_state=64, d_inner=4096 (64 SSD heads);
weight-shared attention+MLP block (d_ff=8192) applied every 6 layers with
per-invocation LoRA (rank 128). Sub-quadratic: runs the long_500k cell.
"""

from repro_torch.models.config import HybridConfig, ModelConfig
from repro_torch.models.ssd import SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
    vocab_size=32000,
    ssm=SSMConfig(d_inner=4096, state_dim=64, head_dim=64),
    hybrid=HybridConfig(segment_len=6, shared_d_ff=8192, lora_rank=128,
                        num_attn_heads=32, num_kv_heads=32),
    subquadratic=True,
)
