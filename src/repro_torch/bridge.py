"""Numpy bridge between the JAX reference's trees and the port's tensors.

The tests build parameters and caches with the reference, convert them
to numpy, and hand them to the port through this module (and back), so
both sides run on identical bits. Nothing here imports JAX: leaves
arrive as numpy arrays.

bf16 leaves: ``np.asarray`` of a JAX bf16 array has dtype
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects, so such
leaves cross through their ``uint16`` bit view. Going back, bf16 tensors
are widened to f32 (exact), which is how the tests compare them.

Name map (reference tree -> port tree):

    embed                      -> params["embed"]                [V, d]
    final_norm/scale           -> params["final_norm"]["scale"]  [d]
    lm_head                    -> params["lm_head"]              [d, V]
    layers/<path> [L, ...]     -> params["layers"][i][<path>]    [...]
    dense_layers/<path> [K, ...] -> params["dense_layers"][i][<path>]
        <path> in ln_attn/scale, ln_mlp/scale,
                  attn/{wq, wk, wv, wo, bq, bk, bv}             (GQA)
                  attn/{wq_a, q_norm, wq_b, wkv_a, kv_norm,
                        wk_b, wv_b, wo}                         (MLA)
                  ffn/{w_gate_up, w_down}                       (MLP)
                  ffn/{router [d, E], w_gate_up [E, d, 2F],
                       w_down [E, F, d],
                       shared/{w_gate_up, w_down}}              (MoE)

The reference's stacks are one [L, ...] leaf per name; the port keeps
one dict per layer (views of one stacked tensor). Caches: the
reference's tuple of one dict per stack — ``(main,)``, or
``(dense_layers, layers)`` for a model with first_k_dense layers — maps
onto ONE port dict whose [L, ...] leaves concatenate the stacks along
the layer axis (dense first): kpool / vpool [L, nb, bs, Hkv, D],
kscale / vscale [L, nb, bs, Hkv]; c_kv [L, nb, bs, C], k_rope
[L, nb, bs, R], c_kv_scale / k_rope_scale [L, nb, bs]; block_table
[L, B, mb], len [L, B]. ``caches_to_reference`` splits it back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device


def from_numpy(a, device=None) -> torch.Tensor:
    """numpy (or anything ``np.asarray`` takes) -> tensor, bit-exact, on
    ``device`` (default: the card; raises without a GPU)."""
    dev = _device.resolve(device)
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy; bf16 widens to f32 exactly."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(tree: dict, device=None) -> dict:
    """Reference parameter tree (numpy leaves) -> the port's tree, with
    the stacked ``dense_layers`` / ``layers`` split into one dict per
    layer. ``device`` defaults to the card."""
    from repro_torch.models import lm
    return lm.split_layers(_map(tree, lambda a: from_numpy(a, device)))


def caches_from_reference(caches, device=None) -> dict:
    """Reference cache tuple (one dict of numpy leaves per stack) -> the
    port's dict, stacks concatenated along the layer axis, on ``device``
    (default: the card)."""
    return {k: from_numpy(np.concatenate([np.asarray(t[k]) for t in caches]),
                          device)
            for k in caches[0]}


def caches_to_numpy(caches: dict) -> dict:
    """Port cache dict -> numpy leaves (bf16 pools widened to f32)."""
    return {k: to_numpy(v) for k, v in caches.items()}


def caches_to_reference(caches: dict, first_k_dense: int = 0) -> tuple:
    """Port cache dict -> the reference's tuple of per-stack numpy dicts
    (bf16 pools widened to f32)."""
    flat = caches_to_numpy(caches)
    if not first_k_dense:
        return (flat,)
    return ({k: v[:first_k_dense] for k, v in flat.items()},
            {k: v[first_k_dense:] for k, v in flat.items()})
