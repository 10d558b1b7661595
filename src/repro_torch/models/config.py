"""Model configuration for the port's dense decoder family
(the dense fields of ``repro.models.config.ModelConfig``)."""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.models.attention import AttnConfig


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # the port serves "dense"
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    act: str = "swiglu"
    rope_theta: float = 1e4
    rotary_fraction: float = 1.0
    tie_embeddings: bool = False
    q_chunk: int = 512
    kv_chunk: int = 512
    kahan_attn: bool = False       # compensated prefill accumulator
    kv_dtype: str = "bf16"         # "bf16" | "int8" | "fp8" KV pools

    def attn(self, *, causal: bool = True) -> AttnConfig:
        return AttnConfig(
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim, qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta, rotary_fraction=self.rotary_fraction,
            q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
            kahan_acc=self.kahan_attn, causal=causal, kv_dtype=self.kv_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def check_supported(self) -> None:
        """The port's first slice serves dense rmsnorm/swiglu decoders."""
        if (self.family, self.norm, self.act) != ("dense", "rmsnorm",
                                                  "swiglu"):
            raise NotImplementedError(
                f"{self.name}: repro_torch serves the dense rmsnorm/swiglu "
                f"family; {self.family}/{self.norm}/{self.act} waits for "
                "ROADMAP queue A step 15")
