"""Model configuration covering every family of the registry (twin of
``repro.models.config``), with the reference's layout knobs that the
production dry run (``launch.dryrun``) sets: ``remat_policy`` and
``sp_residual``. The reference's ``causal_packing`` has no field: the
port's flash attention packs wherever the reference's conditions hold
(``attention.flash_attention``), with the unpacked walk's bits."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

from repro_torch.models.attention import AttnConfig
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssd import SSMConfig


class HybridConfig(NamedTuple):
    """Zamba2-style: Mamba2 backbone + a weight-shared attention block
    applied after every ``segment_len`` SSM layers, with a per-invocation
    LoRA adapter on the shared block's QKV projections."""
    segment_len: int = 6
    shared_d_ff: int = 8192
    lora_rank: int = 128
    num_attn_heads: int = 32
    num_kv_heads: int = 32


class EncDecConfig(NamedTuple):
    """Whisper-style encoder-decoder. The conv/mel frontend is a stub:
    inputs are precomputed frame embeddings [B, enc_seq, d_model]."""
    enc_layers: int = 4
    enc_seq: int = 1500


class VLMConfig(NamedTuple):
    """LLaVA-style: patch embeddings (stub frontend) projected into the
    token stream. anyres tiling is folded into num_patches."""
    vision_dim: int = 1024
    num_patches: int = 576


SERVED_FAMILIES = ("dense", "moe", "ssm", "vlm", "hybrid", "audio")

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
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
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    q_chunk: int = 512
    kv_chunk: int = 512
    remat: bool = True             # training: recompute each layer
                                   # in backward (``lm.lm_forward``)
    remat_policy: str = "nothing"  # nothing | dots: what a recomputed
                                   # layer saves (``lm.REMAT_POLICIES``)
    kahan_attn: bool = False       # compensated prefill accumulator
    kahan_ssm_state: bool = False  # compensated SSD state carry
    kv_dtype: str = "bf16"         # "bf16" | "int8" | "fp8" KV pools
    # layout knob: the residual stream sharded over its sequence
    # (``act_res_seq``)
    sp_residual: bool = False
    # sub-quadratic sequence mixing (gates the long_500k shape cell)
    subquadratic: bool = False

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
        """The port's model API covers every family of the registry:
        dense and vlm, moe (GQA or MLA attention, optional leading dense
        layers) and ssm (Mamba2), with SwiGLU or GELU MLPs (``act``),
        hybrid (Mamba2 + a shared attention block) and audio
        (encoder-decoder), with rmsnorm or layernorm. The serving engine
        takes the lm families; the hybrid and audio families serve
        through the one-shot ``api.prefill_fn`` / ``decode_fn``, as in
        the reference."""
        ok = (self.family in SERVED_FAMILIES
              and self.norm in ("rmsnorm", "layernorm")
              and (self.family == "moe") == (self.moe is not None)
              and (self.family in ("ssm", "hybrid")) == (self.ssm is not None)
              and (self.family == "hybrid") == (self.hybrid is not None)
              and (self.family == "audio") == (self.encdec is not None))
        if not ok:
            raise NotImplementedError(
                f"{self.name}: repro_torch serves the {SERVED_FAMILIES} "
                f"families with rmsnorm or layernorm; "
                f"{self.family}/{self.norm} (moe "
                f"config: {self.moe is not None}, ssm config: "
                f"{self.ssm is not None}) is not one of them")
