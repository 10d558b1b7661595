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
        <path> in ln_attn/scale, ln_mlp/scale,
                  attn/{wq, wk, wv, wo, bq, bk, bv},
                  ffn/{w_gate_up, w_down}

The reference's layer stack is one [L, ...] leaf per name; the port keeps
one dict per layer (views of one stacked tensor). Caches keep the
reference's stacked layout: the reference's ``(caches,)`` tuple of one
dict maps onto the port's dict with the same [L, ...] leaves
(kpool / vpool [L, nb, bs, Hkv, D], kscale / vscale [L, nb, bs, Hkv],
block_table [L, B, mb], len [L, B]).
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy (or anything ``np.asarray`` takes) -> tensor, bit-exact."""
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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


def params_from_reference(tree: dict, device="cpu") -> dict:
    """Reference parameter tree (numpy leaves) -> the port's tree, with
    the stacked ``layers`` split into one dict per layer."""
    from repro_torch.models import lm
    return lm.split_layers(_map(tree, lambda a: from_numpy(a, device)))


def caches_from_reference(caches, device="cpu") -> dict:
    """Reference cache tuple ``(dict,)`` (numpy leaves) -> port dict."""
    (tree,) = caches
    return {k: from_numpy(v, device) for k, v in tree.items()}


def caches_to_numpy(caches: dict) -> dict:
    """Port cache dict -> numpy leaves (bf16 pools widened to f32)."""
    return {k: to_numpy(v) for k, v in caches.items()}
