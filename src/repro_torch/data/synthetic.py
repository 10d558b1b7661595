"""Synthetic training batches (twin of ``repro.data.synthetic``).

``make_batch`` draws from numpy's ``default_rng`` exactly as the
reference does, so a batch is bitwise the reference's; it returns numpy
arrays (the trainer moves them to its device). A vlm batch carries
``patch_embeds`` [B, P, vision_dim] that prefix its seq_len - P text
tokens (with zero loss weight on the P image positions), an audio batch
``frames`` [B, enc_seq, d_model]: the reference's bf16 draws, held as
f32 numpy (bf16 values are exact in f32). ``kind="prefill"`` (any kind
but "train") leaves out the labels and weights. ``train_batch_struct``,
``prefill_batch_struct`` and ``decode_tokens_struct`` give the same
structures as meta tensors (shapes and dtypes, no memory): the inputs
that ``distributed.sharding.batch_shardings`` lays out.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens per sequence: a vlm spends ``num_patches`` of its
    ``seq_len`` positions on image patches."""
    if cfg.family == "vlm":
        return seq_len - cfg.vlm.num_patches
    return seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_struct(cfg: ModelConfig, seq_len: int, batch: int) -> dict:
    lt = _text_len(cfg, seq_len)
    s: dict = {"tokens": _meta((batch, lt), torch.int32),
               "labels": _meta((batch, seq_len), torch.int32),
               "weights": _meta((batch, seq_len), torch.float32)}
    if cfg.family == "vlm":
        s["patch_embeds"] = _meta(
            (batch, cfg.vlm.num_patches, cfg.vlm.vision_dim), torch.bfloat16)
    if cfg.family == "audio":
        s["frames"] = _meta((batch, cfg.encdec.enc_seq, cfg.d_model),
                            torch.bfloat16)
    return s


def prefill_batch_struct(cfg: ModelConfig, seq_len: int, batch: int
                         ) -> dict:
    s = train_batch_struct(cfg, seq_len, batch)
    s.pop("labels")
    s.pop("weights")
    return s


def decode_tokens_struct(batch: int) -> torch.Tensor:
    return _meta((batch, 1), torch.int32)


def _bf16_exact(rng, shape) -> np.ndarray:
    """The reference's f64 normal draws rounded to bf16 (through f32, two
    roundings, as ``jnp.asarray(..., dtype=bfloat16)`` does), held as
    f32."""
    f32 = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(f32).to(torch.bfloat16).to(torch.float32).numpy()


def make_batch(cfg: ModelConfig, seq_len: int, batch: int, *,
               kind: str = "train", seed: int = 0) -> dict:
    """Deterministic batch: ``tokens`` int32 [B, Lt] (Lt = seq_len less a
    vlm's patches), a vlm's ``patch_embeds`` [B, P, vision_dim], an audio
    model's ``frames`` and, for ``kind == "train"``, ``labels`` int32
    [B, seq_len] and ``weights`` f32 [B, seq_len], 0 on a vlm's image
    positions (numpy)."""
    rng = np.random.default_rng(seed)
    lt = _text_len(cfg, seq_len)
    out: dict = {"tokens": rng.integers(0, cfg.vocab_size, size=(batch, lt),
                                        dtype=np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = _bf16_exact(
            rng, (batch, cfg.vlm.num_patches, cfg.vlm.vision_dim))
    if cfg.family == "audio":
        out["frames"] = _bf16_exact(rng, (batch, cfg.encdec.enc_seq,
                                          cfg.d_model))
    if kind == "train":
        out["labels"] = rng.integers(0, cfg.vocab_size,
                                     size=(batch, seq_len), dtype=np.int32)
        weights = np.ones((batch, seq_len), np.float32)
        if cfg.family == "vlm":       # no loss on image positions
            weights[:, :cfg.vlm.num_patches] = 0.0
        out["weights"] = weights
    return out
