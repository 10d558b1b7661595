"""Synthetic training batches (twin of ``repro.data.synthetic``).

``make_batch`` draws from numpy's ``default_rng`` exactly as the
reference does, so a batch is bitwise the reference's; it returns numpy
arrays (the trainer moves them to its device). An audio batch carries
``frames`` [B, enc_seq, d_model]: the reference's bf16 draws, held as
f32 numpy (bf16 values are exact in f32). ``kind="prefill"`` (any kind
but "train") leaves out the labels and weights. The reference's
abstract ``jax.ShapeDtypeStruct`` helpers (the dry-run's inputs) have no
analog here, and a vlm batch's image patches wait for ROADMAP queue A
item 13: a vlm batch is text tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens per sequence: all of them in the port's text-only
    families (the reference's vlm family spends some on image patches)."""
    return seq_len


def make_batch(cfg: ModelConfig, seq_len: int, batch: int, *,
               kind: str = "train", seed: int = 0) -> dict:
    """Deterministic batch: ``tokens`` int32 [B, L], an audio model's
    ``frames`` and, for ``kind == "train"``, ``labels`` int32 [B, L] and
    ``weights`` f32 [B, L] (numpy)."""
    rng = np.random.default_rng(seed)
    lt = _text_len(cfg, seq_len)
    out: dict = {"tokens": rng.integers(0, cfg.vocab_size, size=(batch, lt),
                                        dtype=np.int32)}
    if cfg.family == "audio":
        # the reference's f64 draws -> bf16 go through f32 (two roundings)
        f32 = rng.standard_normal((batch, cfg.encdec.enc_seq,
                                   cfg.d_model)).astype(np.float32)
        out["frames"] = torch.from_numpy(f32).to(torch.bfloat16).to(
            torch.float32).numpy()
    if kind == "train":
        out["labels"] = rng.integers(0, cfg.vocab_size,
                                     size=(batch, seq_len), dtype=np.int32)
        out["weights"] = np.ones((batch, seq_len), np.float32)
    return out
