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
    vision_proj/{w1, w2}       -> params["vision_proj"][...]     (vlm)
    layers/<path> [L, ...]     -> params["layers"][i][<path>]    [...]
    dense_layers/<path> [K, ...] -> params["dense_layers"][i][<path>]
        <path> in ln_attn/scale, ln_mlp/scale (and /bias: layernorm),
                  norm/scale, mixer/{in_proj, conv_w, conv_b, A_log,
                        D, dt_bias, norm, out_proj}             (Mamba2)
                  attn/{wq, wk, wv, wo, bq, bk, bv}             (GQA)
                  attn/{wq_a, q_norm, wq_b, wkv_a, kv_norm,
                        wk_b, wv_b, wo}                         (MLA)
                  ffn/{w_gate_up, w_down}                       (MLP)
                  ffn/{router [d, E], w_gate_up [E, d, 2F],
                       w_down [E, F, d],
                       shared/{w_gate_up, w_down}}              (MoE)

    hybrid: mamba_blocks/<path> [n_seg * seg, ...], mamba_tail/<path>
        -> lists of per-layer dicts (Mamba2 paths as above);
        shared/{ln_attn, attn, ln_mlp, ffn}, lora/{a_q, b_q, a_k, b_k,
        a_v, b_v} [n_seg, ...] as they are (shared/attn/{wq, wk, wv}
        held as the hybrid's schema says)
    audio: enc_layers/<path>, dec_layers/<path> -> lists of per-layer
        dicts (ln_attn, attn, ln_mlp, ffn/{w_up, b_up, w_down, b_down};
        ln_self, self_attn, ln_cross, cross_attn, ln_mlp, ffn);
        enc_norm, dec_norm, embed, pos_embed as they are

The reference's stacks are one [L, ...] leaf per name; the port keeps
one dict per layer (views of one stacked tensor). Caches: the
reference's tuple of one dict per stack — ``(main,)``, or
``(dense_layers, layers)`` for a model with first_k_dense layers — maps
onto ONE port dict whose [L, ...] leaves concatenate the stacks along
the layer axis (dense first): kpool / vpool [L, nb, bs, Hkv, D],
kscale / vscale [L, nb, bs, Hkv]; c_kv [L, nb, bs, C], k_rope
[L, nb, bs, R], c_kv_scale / k_rope_scale [L, nb, bs]; block_table
[L, B, mb], len [L, B]; Mamba2 state ssm [L, B, H, N, P], conv
[L, B, W-1, conv_dim]. ``caches_to_reference`` splits it back. The
hybrid's ``{mamba: {ssm, conv} [n_seg, seg, ...], attn: paged GQA
[n_seg, ...], tail: {ssm, conv} [tail, ...] or None}`` and the audio
family's ``{self: paged GQA [L, ...], cross_k, cross_v [L, B, enc_seq,
Hkv, D]}`` cross as they are.
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


def params_from_reference(tree: dict, device=None, *,
                          hold_bf16: bool = True, cfg=None) -> dict:
    """Reference parameter tree (numpy leaves) -> the port's tree, with
    the stacked ``dense_layers`` / ``layers`` split into one dict per
    layer and, for serving, the weights that only feed bf16 products
    held as bf16 (``models.common.BF16_WEIGHTS``; they are rounded to
    bf16 before every product anyway, so no result changes), except the
    leaves that ``cfg``'s schema keeps f32 (the hybrid's LoRA-folded
    q / k / v: a hybrid tree needs its ``cfg``). ``hold_bf16=False``
    keeps every leaf's bits as they are: a training master, whose f32
    bits the optimizer updates, for any family (MoE experts [E, ...],
    MLA, the hybrid's LoRA and shared block, the encoder-decoder's two
    stacks, the vlm's projection). ``device`` defaults to the card."""
    from repro_torch.models import api, common, lm
    tree = _map(tree, lambda a: from_numpy(a, device))
    if hold_bf16:
        tree = common.hold_weights_bf16(
            tree, None if cfg is None else api.schema(cfg))
    return lm.split_layers(tree)


def caches_from_reference(caches, device=None) -> dict:
    """Reference caches (numpy leaves) -> the port's, on ``device``
    (default: the card). An lm family's tuple of one dict per stack
    becomes one dict, the stacks concatenated along the layer axis; the
    hybrid's ``{mamba, attn, tail}`` and the audio family's ``{self,
    cross_k, cross_v}`` trees keep their shape (a missing tail stays
    None)."""
    if isinstance(caches, dict):
        return _map(caches, lambda a: None if a is None
                    else from_numpy(a, device))
    return {k: from_numpy(np.concatenate([np.asarray(t[k]) for t in caches]),
                          device)
            for k in caches[0]}


def caches_to_numpy(caches: dict) -> dict:
    """Port caches -> numpy leaves (bf16 pools widened to f32), nested
    trees and None leaves as they are."""
    return _map(caches, lambda t: None if t is None else to_numpy(t))


def caches_to_reference(caches: dict, first_k_dense: int = 0):
    """Port caches -> the reference's layout (bf16 pools widened to
    f32): an lm family's tuple of per-stack numpy dicts, or the hybrid's
    and audio family's nested tree as it is."""
    flat = caches_to_numpy(caches)
    if any(isinstance(v, dict) or v is None for v in flat.values()):
        return flat
    if not first_k_dense:
        return (flat,)
    return ({k: v[:first_k_dense] for k, v in flat.items()},
            {k: v[first_k_dense:] for k, v in flat.items()})
