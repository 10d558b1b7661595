"""whisper-tiny — audio enc-dec [arXiv:2212.04356].

4L+4L d_model=384 6H d_ff=1536 vocab=51865; conv/mel frontend is a STUB
(input_specs provides precomputed frame embeddings [B, 1500, 384]).
"""

from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio", num_layers=4, d_model=384,
    num_heads=6, num_kv_heads=6, head_dim=64, d_ff=1536, vocab_size=51865,
    norm="layernorm", act="gelu",
    encdec=EncDecConfig(enc_layers=4, enc_seq=1500),
)
