"""Model configuration for the port's decoder families (the dense, MoE and
MLA fields of ``repro.models.config.ModelConfig``)."""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.models.attention import AttnConfig
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # the port serves "dense" and "moe"
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
    moe: MoEConfig | None = None
    first_k_dense: int = 0         # DeepSeek-V2: leading dense layers
    dense_d_ff: int = 0            # ... their FFN width
    mla: MLAConfig | None = None
    q_chunk: int = 512
    kv_chunk: int = 512
    kahan_attn: bool = False       # compensated prefill accumulator
    kv_dtype: str = "bf16"         # "bf16" | "int8" | "fp8" KV pools
    remat: bool = True             # training: recompute each layer
                                   # in backward (``lm.lm_forward``)

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
        """The port serves rmsnorm/swiglu decoders of the dense family and
        of the moe family (GQA or MLA attention, optional leading dense
        layers)."""
        ok = (self.family in ("dense", "moe")
              and (self.norm, self.act) == ("rmsnorm", "swiglu")
              and (self.family == "moe") == (self.moe is not None))
        if not ok:
            raise NotImplementedError(
                f"{self.name}: repro_torch serves the dense and moe "
                f"rmsnorm/swiglu families; {self.family}/{self.norm}/"
                f"{self.act} (moe config: {self.moe is not None}) waits for "
                "ROADMAP queue A item 12")
