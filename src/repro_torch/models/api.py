"""Public model API used by the serving engine (twin of
``repro.models.api`` for the dense and moe families).

Entry points run on the card unless the caller passes a device:
``init_params(cfg, generator, device=None)`` and ``KVCache.init(...,
device=None)`` resolve ``None`` to CUDA and raise without a GPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import device as _device
from repro_torch.models import common, lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import (DEFAULT_BLOCK_SIZE, POOL_KEYS,
                                      PagedLayout, default_num_blocks)


def schema(cfg: ModelConfig) -> dict:
    cfg.check_supported()
    return lm.lm_schema(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, seed: int = 0, hold_bf16: bool = True) -> dict:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` (default: a fresh one on ``device`` seeded ``seed``).
    The weights that only feed bf16 products are held as bf16
    (``common.BF16_WEIGHTS``); ``hold_bf16=False`` keeps every leaf f32,
    the reference's tree as it stands (a training master copy)."""
    dev = _device.resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return lm.split_layers(common.init_params(schema(cfg), generator, dev,
                                              hold_bf16=hold_bf16))


def decode_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens [B, 1], caches) -> logits [B, V]; caches in place."""
    cfg.check_supported()
    return lambda p, t, c: lm.lm_decode(p, t, c, cfg)


def prefill_chunk_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens [1, C], caches, slot, pos0) -> logits [1, V];
    caches in place. The slot's tables must already point at allocated
    blocks (``paged.reset_slot``)."""
    cfg.check_supported()
    return lambda p, t, c, slot, pos0: lm.lm_prefill_chunk(p, t, c, slot,
                                                          pos0, cfg)


def verify_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens [S, C], caches, slots [S], pos0s [S]) -> logits
    [S, C, V] f32; caches in place.

    One pass appends and scores every slot's draft window against the
    paged KV (quantized pools included); position j's logits score the
    token after tokens[:, j]. The caller rolls rejected suffixes back
    with ``paged.set_lens``. Paged-KV attention families only."""
    if cfg.family in ("audio", "hybrid", "ssm"):
        raise NotImplementedError(
            f"speculative verify serves paged-KV attention families, "
            f"not {cfg.family!r}")
    cfg.check_supported()
    return lambda p, t, c, slots, pos0s: lm.lm_verify_chunk(p, t, c, slots,
                                                           pos0s, cfg)


def to_device(tree, device):
    """A parameter tree (nested dicts and per-layer lists) on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def num_params(tree) -> int:
    """Parameter count of a tree (nested dicts and per-layer lists)."""
    if isinstance(tree, dict):
        return sum(num_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(num_params(v) for v in tree)
    return tree.numel()


@dataclass(frozen=True)
class KVCache:
    """A model's paged KV-cache geometry: config + layout + pool size."""

    cfg: ModelConfig
    layout: PagedLayout
    num_blocks: int            # per-layer pool blocks, incl. null block 0

    @staticmethod
    def build(cfg: ModelConfig, *, max_context: int,
              block_size: int | None = None, max_slots: int = 1,
              num_blocks: int | None = None) -> "KVCache":
        bs = DEFAULT_BLOCK_SIZE if block_size is None else block_size
        layout = PagedLayout.for_context(max_context, bs)
        if num_blocks is None:
            num_blocks = default_num_blocks(layout, max_slots)
        return KVCache(cfg, layout, num_blocks)

    def specs(self, batch: int) -> dict:
        return lm.lm_cache_specs(self.cfg, batch, self.layout,
                                 num_blocks=self.num_blocks)

    def init(self, batch: int, device=None) -> dict:
        dev = _device.resolve(device)
        return {k: torch.zeros(shape, dtype=dtype, device=dev)
                for k, (shape, dtype) in self.specs(batch).items()}

    def blocks_for(self, num_tokens: int) -> int:
        return self.layout.blocks_for(num_tokens)

    def token_bytes(self, batch: int = 1) -> int:
        """Paged-cache bytes per cached token, summed over every pool
        leaf and layer (MLA in bf16: (kv_lora + rope_dim) * 2 = 1152
        bytes per layer at full width)."""
        total = 0
        for name, (shape, dtype) in self.specs(batch).items():
            if name in POOL_KEYS:
                itemsize = torch.empty((), dtype=dtype).element_size()
                total += shape[0] * math.prod(shape[3:]) * itemsize
        return total
