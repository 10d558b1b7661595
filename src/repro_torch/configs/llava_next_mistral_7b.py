"""llava-next-mistral-7b — VLM [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
anyres tiling frontend is a STUB: input_specs provides precomputed patch
embeddings [B, num_patches, vision_dim] (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=32000,
    vlm=VLMConfig(vision_dim=1024, num_patches=576),
)
