"""Decoder-only LM assembly for serving (twin of ``repro.models.lm``).

The reference scans stacked layer trees with ``lax.scan``: an optional
``dense_layers`` stack (DeepSeek-V2's first_k_dense layers, dense FFN)
and the main ``layers`` stack. The port loops over
``params["dense_layers"]`` then ``params["layers"]``, one dict per layer.

Caches: the reference keeps one cache tree per stack, the tuple
``(dense_stack, main_stack)``. Both stacks have the same per-layer cache
spec, so the port concatenates them along the layer axis into ONE dict
of [L, ...] leaves (dense layers first); layer i gets the view
``{name: leaf[i]}``, so in-place cache updates land in the stacked
tensors, and the cache-tree moves of ``models.paged`` see every layer.
``bridge.caches_from_reference`` / ``caches_to_reference`` convert.
"""

from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.blocks import (block_cache_spec, block_decode,
                                       block_prefill_chunk, block_schema,
                                       dense_block_schema, stack_schema)
from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import PagedLayout

STACKS = ("dense_layers", "layers")


def lm_schema(cfg: ModelConfig) -> dict:
    """The reference's schema: stack leaves are [L_stack, ...]."""
    s = {"embed": ParamSpec((cfg.vocab_size, cfg.d_model), init="normal"),
         "final_norm": common.norm_schema(cfg.d_model)}
    if cfg.first_k_dense:
        s["dense_layers"] = stack_schema(
            dense_block_schema(cfg, cfg.dense_d_ff), cfg.first_k_dense)
    s["layers"] = stack_schema(block_schema(cfg),
                               cfg.num_layers - cfg.first_k_dense)
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 init="fan_in")
    return s


def split_layers(params: dict) -> dict:
    """Stacked ``dense_layers`` / ``layers`` leaves [L, ...] -> lists of
    per-layer dicts (views of the stacked tensors)."""

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    def first(tree):
        while isinstance(tree, dict):
            tree = next(iter(tree.values()))
        return tree

    out = dict(params)
    for name in STACKS:
        if name in params:
            n = first(params[name]).shape[0]
            out[name] = [pick(params[name], i) for i in range(n)]
    return out


def _layers(params: dict):
    """(cache layer index, layer params, dense_ffn) over both stacks."""
    dense = params.get("dense_layers", [])
    for i, p in enumerate(dense):
        yield i, p, True
    for i, p in enumerate(params["layers"]):
        yield len(dense) + i, p, False


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
    for i, p, dense_ffn in _layers(params):
        h = block_prefill_chunk(p, h, cfg, layer_cache(caches, i), slot,
                                pos0, dense_ffn=dense_ffn)
    h = common.rms_norm(h, params["final_norm"]["scale"])
    return _serving_logits(h[:, -1], params, cfg)


def lm_decode(params: dict, tokens: torch.Tensor, caches: dict,
              cfg: ModelConfig) -> torch.Tensor:
    """One decode step for every slot (tokens [B, 1]); caches update in
    place. Returns logits [B, V] f32."""
    h = _embed(params, tokens)
    for i, p, dense_ffn in _layers(params):
        h = block_decode(p, h, cfg, layer_cache(caches, i),
                         dense_ffn=dense_ffn)
    h = common.rms_norm(h, params["final_norm"]["scale"])
    return _serving_logits(h[:, -1], params, cfg)


def lm_cache_specs(cfg: ModelConfig, batch: int, layout: PagedLayout,
                   num_blocks: int | None = None) -> dict:
    """{leaf: (shape, dtype)} with every leaf stacked over the layers of
    both stacks (dense first): one block id addresses that block in every
    layer's pool, and the same table drives every layer."""
    per_layer = block_cache_spec(cfg, batch, layout, num_blocks=num_blocks)
    return {k: ((cfg.num_layers,) + shape, dtype)
            for k, (shape, dtype) in per_layer.items()}
