"""qwen1.5-110b — dense GQA [hf:Qwen family]. QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=49152,
    vocab_size=152064, qkv_bias=True,
)
