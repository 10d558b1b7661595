"""qwen1.5-32b — dense [hf:Qwen family]. QKV bias.

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense", num_layers=64, d_model=5120,
    num_heads=40, num_kv_heads=40, head_dim=128, d_ff=27392,
    vocab_size=152064, qkv_bias=True,
)
