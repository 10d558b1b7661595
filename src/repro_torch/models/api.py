"""Public model API used by the serving engine, the one-shot server and
the trainer (twin of ``repro.models.api``; every family trains through
``loss_fn`` / ``forward_fn``). Every family serves through the one-shot
``prefill_fn`` / ``decode_fn``; the lm families (dense, moe, ssm, vlm)
also through the engine's chunked ``prefill_chunk_fn``. Cache trees:
one dict of [L, ...] leaves for the lm families, ``{mamba, attn, tail}``
for the hybrid and ``{self, cross_k, cross_v}`` for the audio family
(``KVCache.specs`` / ``init`` build them). An ssm model's ``KVCache``
holds constant-size per-slot state, no pools, so its ``token_bytes`` is
0.

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
from repro_torch.models import attention, common, encdec, hybrid, lm
from repro_torch.models.blocks import check_trainable
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import (DEFAULT_BLOCK_SIZE, POOL_KEYS,
                                      PagedLayout, as_layout,
                                      default_num_blocks)

MAX_DEC_POSITIONS = 32768   # learned decoder positions (audio family)


def schema(cfg: ModelConfig) -> dict:
    cfg.check_supported()
    if cfg.family == "audio":
        return encdec.encdec_schema(cfg, MAX_DEC_POSITIONS)
    if cfg.family == "hybrid":
        return hybrid.hybrid_schema(cfg)
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


def forward_fn(cfg: ModelConfig) -> Callable:
    """(params, batch) -> (logits [B, L, V] bf16, aux): the training
    forward of any family (the lm families' aux holds the MoE losses,
    the hybrid's and audio's is empty)."""
    check_trainable(cfg)
    if cfg.family == "audio":
        return lambda p, b: encdec.encdec_forward(p, b, cfg)
    if cfg.family == "hybrid":
        return lambda p, b: hybrid.hybrid_forward(p, b, cfg)
    return lambda p, b: lm.lm_forward(p, b, cfg)


def loss_fn(cfg: ModelConfig) -> Callable:
    """(params, batch) -> (loss, metrics): the weighted cross entropy the
    trainer differentiates, plus a MoE model's aux losses, with the
    reference's metric keys for each family. It runs beside what its
    cross entropy holds, or (an lm family) what its end holds beyond its
    first layer's backward where that is more (``attention.beside_loss``):
    flash attention checkpoints each query block only where a layer's
    scores and transient outweigh it."""
    check_trainable(cfg)
    loss = {"audio": encdec.encdec_loss,
            "hybrid": hybrid.hybrid_loss}.get(cfg.family, lm.lm_loss)

    def fn(params, batch):
        head = params.get("lm_head")
        nbytes = attention.loss_bytes(
            batch["labels"], params["embed"] if head is None else head,
            0 if head is None else -1)
        if loss is lm.lm_loss:
            nbytes = max(nbytes, attention.grads_after_first_layer(
                lm.first_layer_leaves(params, cfg), batch["labels"],
                cfg.d_model))
        with attention.beside_loss(nbytes):
            return loss(params, batch, cfg)
    return fn


def prefill_fn(cfg: ModelConfig, cache_spec) -> Callable:
    """One-shot prefill: (params, batch) -> (last position's logits
    [B, V], fresh caches with identity block tables). ``cache_spec``: the
    max context (int) or a ``PagedLayout``. ``batch`` holds ``tokens``
    [B, L] (and a vlm's ``patch_embeds``, an audio model's ``frames``)
    on the parameters' device. The lm families' logits are the f32
    serving head's, the hybrid's and audio's bf16, as in the
    reference."""
    cfg.check_supported()
    layout = as_layout(cache_spec)
    if cfg.family == "audio":
        return lambda p, b: encdec.encdec_prefill(p, b, cfg, layout)
    if cfg.family == "hybrid":
        return lambda p, b: hybrid.hybrid_prefill(p, b, cfg, layout)
    return lambda p, b: lm.lm_prefill(p, b, cfg, layout)


def decode_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens [B, 1], caches) -> logits [B, V]; caches in place."""
    cfg.check_supported()
    if cfg.family == "audio":
        return lambda p, t, c: encdec.encdec_decode(p, t, c, cfg)
    if cfg.family == "hybrid":
        return lambda p, t, c: hybrid.hybrid_decode(p, t, c, cfg)
    return lambda p, t, c: lm.lm_decode(p, t, c, cfg)


def prefill_chunk_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens [1, C], caches, slot, pos0) -> logits [1, V];
    caches in place. The slot's tables must already point at allocated
    blocks (``paged.reset_slot``). The lm families only: the hybrid and
    audio families serve through the one-shot ``prefill_fn``."""
    if cfg.family in ("audio", "hybrid"):
        raise NotImplementedError(
            f"chunked prefill serves lm families, not {cfg.family!r}")
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


def cache_specs(cfg: ModelConfig, batch: int, cache_spec, *,
                num_blocks: int | None = None) -> dict:
    """The cache tree as {leaf: (shape, dtype)} (nested for the hybrid
    and audio families; the hybrid's ``tail`` None without a tail).
    ``num_blocks`` overrides the per-layer pool size."""
    cfg.check_supported()
    layout = as_layout(cache_spec)
    if cfg.family == "audio":
        return encdec.encdec_cache_specs(cfg, batch, layout,
                                         num_blocks=num_blocks)
    if cfg.family == "hybrid":
        return hybrid.hybrid_cache_specs(cfg, batch, layout,
                                         num_blocks=num_blocks)
    return lm.lm_cache_specs(cfg, batch, layout, num_blocks=num_blocks)


def _spec_leaves(spec):
    """(leaf name, (shape, dtype)) over a nested spec tree."""
    for k, v in (spec or {}).items():
        if isinstance(v, dict) or v is None:
            yield from _spec_leaves(v)
        else:
            yield k, v


def to_device(tree, device):
    """A tree (nested dicts, per-layer lists, None) on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return None if tree is None else tree.to(device)


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
        return cache_specs(self.cfg, batch, self.layout,
                           num_blocks=self.num_blocks)

    def init(self, batch: int, device=None) -> dict:
        dev = _device.resolve(device)

        def zeros(spec):
            if spec is None:
                return None
            return {k: (zeros(v) if isinstance(v, dict) else
                        torch.zeros(v[0], dtype=v[1], device=dev))
                    for k, v in spec.items()}

        return zeros(self.specs(batch))

    def blocks_for(self, num_tokens: int) -> int:
        return self.layout.blocks_for(num_tokens)

    def token_bytes(self, batch: int = 1) -> int:
        """Paged-cache bytes per cached token, summed over every pool
        leaf and layer (MLA in bf16: (kv_lora + rope_dim) * 2 = 1152
        bytes per layer at full width). The hybrid's pools are its
        shared block's, one per block call; the audio family's its
        decoder self-attention's (the cross K/V are not pooled)."""
        total = 0
        for name, (shape, dtype) in _spec_leaves(self.specs(batch)):
            if name in POOL_KEYS:
                itemsize = torch.empty((), dtype=dtype).element_size()
                total += shape[0] * math.prod(shape[3:]) * itemsize
        return total
