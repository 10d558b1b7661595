"""stablelm-3b — dense [hf:stabilityai/stablelm-2-1_6b family].

32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304; LayerNorm + partial
rotary (25%%), per the StableLM-2 family.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", num_layers=32, d_model=2560,
    num_heads=32, num_kv_heads=32, head_dim=80, d_ff=6912, vocab_size=50304,
    norm="layernorm", rotary_fraction=0.25,
)
