"""Decoder-only LM assembly for serving (twin of ``repro.models.lm``).

The reference scans a stacked layer tree with ``lax.scan``; the port
loops over ``params["layers"]``, one dict per layer, and hands layer i
the view ``{name: leaf[i]}`` of the layer-stacked cache dict, so the
in-place cache updates land in the stacked tensors.
"""

from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.blocks import (block_cache_spec, block_decode,
                                       block_prefill_chunk, block_schema,
                                       stack_schema)
from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import PagedLayout


def lm_schema(cfg: ModelConfig) -> dict:
    """The reference's schema: ``layers`` leaves stacked [L, ...]."""
    s = {"embed": ParamSpec((cfg.vocab_size, cfg.d_model), init="normal"),
         "final_norm": common.norm_schema(cfg.d_model),
         "layers": stack_schema(block_schema(cfg), cfg.num_layers)}
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 init="fan_in")
    return s


def split_layers(params: dict) -> dict:
    """Stacked ``layers`` leaves [L, ...] -> a list of per-layer dicts
    (views of the stacked tensors)."""

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    def first(tree):
        while isinstance(tree, dict):
            tree = next(iter(tree.values()))
        return tree

    n = first(params["layers"]).shape[0]
    return {**params, "layers": [pick(params["layers"], i)
                                 for i in range(n)]}


def layer_cache(caches: dict, i: int) -> dict:
    """Layer i's view of the layer-stacked cache dict."""
    return {k: v[i] for k, v in caches.items()}


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.to(torch.int64)].to(torch.bfloat16)


def _serving_logits(h: torch.Tensor, params: dict,
                    cfg: ModelConfig) -> torch.Tensor:
    """LM-head projection computed AND kept in f32 (greedy serving
    argmaxes the raw logits; bf16 ties would make the argmax depend on
    the attention formulation)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return common.dense(h, head, compute_dtype=torch.float32)


def lm_prefill_chunk(params: dict, tokens: torch.Tensor, caches: dict,
                     slot: int, pos0: int, cfg: ModelConfig) -> torch.Tensor:
    """Prefill one chunk (tokens [1, C]) of the sequence in ``slot``;
    caches update in place. Returns the last position's logits [1, V]."""
    h = _embed(params, tokens)
    for i, p in enumerate(params["layers"]):
        h = block_prefill_chunk(p, h, cfg, layer_cache(caches, i), slot,
                                pos0)
    h = common.rms_norm(h, params["final_norm"]["scale"])
    return _serving_logits(h[:, -1], params, cfg)


def lm_decode(params: dict, tokens: torch.Tensor, caches: dict,
              cfg: ModelConfig) -> torch.Tensor:
    """One decode step for every slot (tokens [B, 1]); caches update in
    place. Returns logits [B, V] f32."""
    h = _embed(params, tokens)
    for i, p in enumerate(params["layers"]):
        h = block_decode(p, h, cfg, layer_cache(caches, i))
    h = common.rms_norm(h, params["final_norm"]["scale"])
    return _serving_logits(h[:, -1], params, cfg)


def lm_cache_specs(cfg: ModelConfig, batch: int, layout: PagedLayout,
                   num_blocks: int | None = None) -> dict:
    """{leaf: (shape, dtype)} with every leaf stacked over layers: one
    block id addresses that block in every layer's pool, and the same
    table drives the whole stack."""
    per_layer = block_cache_spec(cfg, batch, layout, num_blocks=num_blocks)
    return {k: ((cfg.num_layers,) + shape, dtype)
            for k, (shape, dtype) in per_layer.items()}
