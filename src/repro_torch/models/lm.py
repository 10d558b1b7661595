"""Decoder-only LM assembly for serving and training (twin of
``repro.models.lm``): the dense, moe, ssm (Mamba2) and vlm families
(a vlm serves text tokens; its projected patches prefix the tokens in
``lm_forward``); training: ``lm_forward`` / ``lm_loss``, every lm
family (a MoE model's loss adds its layers' aux losses).

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

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import kahan
from repro_torch.kernels.serving_head import serving_head
from repro_torch.models import common
from repro_torch.models.attention import keeping_loss_bytes
from repro_torch.models.blocks import (AUX_KEYS, block_apply,
                                       block_cache_spec, block_decode,
                                       block_prefill, block_prefill_chunk,
                                       block_schema,
                                       block_verify_chunk,
                                       dense_block_schema, stack_schema)
from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import PagedLayout

# every family's stacked layer trees: the lm stacks, the hybrid's Mamba2
# segments and tail, the encoder-decoder's two stacks
STACKS = ("dense_layers", "layers", "mamba_blocks", "mamba_tail",
          "enc_layers", "dec_layers")


def lm_schema(cfg: ModelConfig) -> dict:
    """The reference's schema: stack leaves are [L_stack, ...]."""
    s = {"embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="normal"),
         "final_norm": common.norm_schema(cfg.d_model, cfg.norm)}
    if cfg.first_k_dense:
        s["dense_layers"] = stack_schema(
            dense_block_schema(cfg, cfg.dense_d_ff), cfg.first_k_dense)
    s["layers"] = stack_schema(block_schema(cfg),
                               cfg.num_layers - cfg.first_k_dense)
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"), init="fan_in")
    if cfg.vlm is not None:
        s["vision_proj"] = {
            "w1": ParamSpec((cfg.vlm.vision_dim, cfg.d_model),
                            (None, "embed"), init="fan_in"),
            "w2": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed_out"),
                            init="fan_in"),
        }
    return s


def split_layers(params: dict) -> dict:
    """Stacked layer leaves [L, ...] (any of ``STACKS``) -> lists of
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


def first_layer_leaves(params: dict, cfg: ModelConfig) -> list:
    """The parameters whose gradients a training step makes after its
    first layer's walk (``attention.grads_after_first_layer``): the first
    layer's, a vlm's projector's and the embedding's, unless the head
    shares it (its gradient then starts at the head, first)."""
    leaves = kahan.tree_leaves(next(_layers(params))[1])
    leaves += kahan.tree_leaves(params.get("vision_proj", {}))
    if not cfg.tie_embeddings:
        leaves.append(params["embed"])
    return leaves


def layer_cache(caches: dict, i: int) -> dict:
    """Layer i's view of the layer-stacked cache dict."""
    return {k: v[i] for k, v in caches.items()}


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return common.embed_tokens(params["embed"], tokens)


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig
                  ) -> torch.Tensor:
    """Token embeddings, prefixed for a vlm batch that carries
    ``patch_embeds`` [B, P, vision_dim] by the projected patches (two
    bf16 products with a tanh GELU between them)."""
    h = _embed(params, batch["tokens"])
    if cfg.vlm is not None and "patch_embeds" in batch:
        vp = params["vision_proj"]
        v = common.dense(batch["patch_embeds"].to(torch.bfloat16), vp["w1"])
        v = common.dense(common.gelu(v.to(torch.float32)).to(v.dtype),
                         vp["w2"])
        h = torch.cat([v, h], dim=1)     # image tokens prefix the text
    return h


# the products with no batch dims (``dense``: [M, K] x [K, N]; the
# batched expert and attention products are ``bmm``s)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.mm.dtype,
                   torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


# what a recomputed layer keeps from its forward: the reference's
# ``jax.checkpoint_policies`` ``nothing_saveable`` and
# ``dots_with_no_batch_dims_saveable``
REMAT_POLICIES = {"nothing": None, "dots": _save_dots}


def remat(fn, cfg: ModelConfig, *args, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in backward by
    ``cfg.remat_policy``: "nothing" saves no tensor inside ``fn``, "dots"
    the outputs of its products with no batch dims. Recompute is
    deterministic, so both give the same bits; it runs under the
    forward's ``attention.beside_loss``, so each walk takes its form
    again."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: not one of "
                         f"{sorted(REMAT_POLICIES)}")
    policy = REMAT_POLICIES[cfg.remat_policy]
    if policy is not None:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return checkpoint(keeping_loss_bytes(fn), *args, use_reentrant=False,
                      **kwargs)


def lm_forward(params: dict, batch: dict, cfg: ModelConfig
               ) -> tuple[torch.Tensor, dict]:
    """Full-sequence training forward: (logits [B, L, V] bf16, aux).

    Embed, cast to bf16, the layers (each recomputed in backward under
    ``cfg.remat`` by ``cfg.remat_policy``, ``remat``, which changes no
    bit), the final norm, then the bf16 head through ``dense`` (not the
    serving f32 head)."""
    h = _embed_inputs(params, batch, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    aux = dict.fromkeys(AUX_KEYS, zero)
    for _, p, dense_ffn in _layers(params):
        if cfg.remat:
            h, a = remat(block_apply, cfg, p, h, cfg, dense_ffn=dense_ffn)
        else:
            h, a = block_apply(p, h, cfg, dense_ffn=dense_ffn)
        aux = {k: aux[k] + a[k] for k in AUX_KEYS}
    h = common.apply_norm(common.residual(h), params["final_norm"],
                          cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return common.dense(h, head), aux


def lm_loss(params: dict, batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, dict]:
    """Weighted causal-LM cross entropy in f32 (+ the MoE aux losses, 0
    for a dense model): (loss, metrics) with the reference's metric
    keys."""
    logits, aux = lm_forward(params, batch, cfg)
    loss, metrics = common.weighted_ce(logits, batch)
    total = loss + aux["moe_load_balance"] + aux["moe_z_loss"]
    return total, {"ce_loss": loss, **aux, "tokens": metrics["tokens"]}


def _serving_logits(h: torch.Tensor, params: dict,
                    cfg: ModelConfig) -> torch.Tensor:
    """LM-head projection computed AND kept in f32 (greedy serving
    argmaxes the raw logits; bf16 ties would make the argmax depend on
    the attention formulation). On the card it runs the serving-head
    kernel, whose rows do not depend on how many rows share the call, so
    a verify window's logits are the decode steps' own; the tied
    embedding is read in place."""
    if cfg.tie_embeddings:
        return serving_head(h, params["embed"], tied=True)
    return serving_head(h, params["lm_head"])


def lm_prefill(params: dict, batch: dict, cfg: ModelConfig,
               layout: PagedLayout) -> tuple[torch.Tensor, dict]:
    """One-shot prefill of a batch (``tokens`` [B, L], and a vlm's
    ``patch_embeds`` prefixing them) into fresh caches with identity
    block tables: (last position's f32 logits [B, V], caches), the
    caches one dict of [L, ...] leaves as ``lm_cache_specs`` lays out,
    ready for ``lm_decode``."""
    h = _embed_inputs(params, batch, cfg)
    per_layer = []
    for _, p, dense_ffn in _layers(params):
        h, cache = block_prefill(p, h, cfg, layout, dense_ffn=dense_ffn)
        per_layer.append(cache)
    h = common.apply_norm(common.residual(h), params["final_norm"],
                          cfg.norm)
    caches = {k: torch.stack([c[k] for c in per_layer])
              for k in per_layer[0]}
    return _serving_logits(h[:, -1], params, cfg), caches


def lm_prefill_chunk(params: dict, tokens: torch.Tensor, caches: dict,
                     slot: int, pos0: int, cfg: ModelConfig) -> torch.Tensor:
    """Prefill one chunk (tokens [1, C]) of the sequence in ``slot``;
    caches update in place. Returns the last position's logits [1, V]."""
    h = _embed(params, tokens)
    for i, p, dense_ffn in _layers(params):
        h = block_prefill_chunk(p, h, cfg, layer_cache(caches, i), slot,
                                pos0, dense_ffn=dense_ffn)
    h = common.apply_norm(common.residual(h), params["final_norm"],
                          cfg.norm)
    return _serving_logits(h[:, -1], params, cfg)


def lm_decode(params: dict, tokens: torch.Tensor, caches: dict,
              cfg: ModelConfig) -> torch.Tensor:
    """One decode step for every slot (tokens [B, 1]); caches update in
    place. Returns logits [B, V] f32."""
    h = _embed(params, tokens)
    for i, p, dense_ffn in _layers(params):
        h = block_decode(p, h, cfg, layer_cache(caches, i),
                         dense_ffn=dense_ffn)
    h = common.apply_norm(common.residual(h), params["final_norm"],
                          cfg.norm)
    return _serving_logits(h[:, -1], params, cfg)


def lm_verify_chunk(params: dict, tokens: torch.Tensor, caches: dict,
                    slots: torch.Tensor, pos0s: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Speculative verify: score a C-token window for each of S slots
    (tokens [S, C], row s landing at ``pos0s[s]``..) in one pass through
    the layers; caches update in place. Returns EVERY position's f32
    logits [S, C, V]: position j scores the token after tokens[s, j]."""
    h = _embed(params, tokens)
    for i, p, dense_ffn in _layers(params):
        h = block_verify_chunk(p, h, cfg, layer_cache(caches, i), slots,
                               pos0s, dense_ffn=dense_ffn)
    h = common.apply_norm(common.residual(h), params["final_norm"],
                          cfg.norm)
    return _serving_logits(h, params, cfg)


def lm_cache_specs(cfg: ModelConfig, batch: int, layout: PagedLayout,
                   num_blocks: int | None = None) -> dict:
    """{leaf: (shape, dtype)} with every leaf stacked over the layers of
    both stacks (dense first): one block id addresses that block in every
    layer's pool, and the same table drives every layer. A Mamba2 stack
    holds per-slot recurrent state instead: ssm [L, B, H, N, P] f32 and
    conv [L, B, W-1, conv_dim] bf16, with no pools, tables or lengths."""
    per_layer = block_cache_spec(cfg, batch, layout, num_blocks=num_blocks)
    return {k: ((cfg.num_layers,) + shape, dtype)
            for k, (shape, dtype) in per_layer.items()}
