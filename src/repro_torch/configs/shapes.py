"""The assigned input-shape set and the (arch × shape) cell enumeration."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def shapes_for(cfg) -> list[str]:
    """Applicable shape cells for an architecture (DESIGN.md §4.1).

    long_500k requires sub-quadratic attention: run for ssm/hybrid, skip for
    pure full-attention archs. No encoder-only archs are assigned (whisper
    is enc-dec, so it keeps its decode shapes).
    """
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names
