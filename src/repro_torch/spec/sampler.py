"""Exact accept rules for speculative decoding (twin of
``repro.spec.sampler``).

The emitted stream must be distributed exactly as the target's own
sampling scheme. Greedy requests keep the argmax-prefix rule (accept
drafts while they equal the target's argmax, then emit the target's own
choice), so the stream is the non-speculative greedy stream. Sampled
requests get the accept / residual construction of Leviathan et al.:
accept draft x with probability min(1, p(x) / q(x)), else draw from the
normalized residual (p - q)+; the emitted marginal is exactly p for any
proposal q, the n-gram proposer's point mass included.

Every draw is keyed on the request's (seed, emit index), the
non-speculative engine's stream, plus a role salt, so a request's tokens
depend only on its seed and history. These are host rules over numpy
float64, as in the reference; the scalar uniforms come from
``repro_torch.core.prng`` on host keys.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng

# Role salts folded into the per-emit-index key. The non-speculative
# engine draws with the unsalted key; speculation needs up to two
# independent draws per position.
ACCEPT_SALT = 1     # the accept / reject uniform
RESIDUAL_SALT = 2   # the residual draw after a rejection
BONUS_SALT = 3      # the bonus draw when every draft was accepted
DRAFT_SALT = 7      # the draft model's own proposal draw


def emit_key(seed: int, emit_index: int) -> torch.Tensor:
    """The request's stream at one emit index (the engine's
    ``_sample_key``), as a host key."""
    return prng.fold_in(prng.key(seed, device="cpu"), emit_index)


def _uniform(key: torch.Tensor) -> float:
    return float(prng.uniform(key))


def target_dist(row: np.ndarray, temperature: float, top_k: int
                ) -> np.ndarray:
    """The engine's sampling distribution for one logit row: temperature
    scaling and top-k truncation, keeping values tied with the k-th
    largest (as ``_sample_rows``)."""
    z = row.astype(np.float64) / max(temperature, 1e-6)
    if top_k:
        k = min(top_k, z.shape[-1])
        # the k-th largest value, which a full sort would give too:
        # partition finds the same number without sorting the row
        kth = np.partition(z, z.shape[-1] - k)[z.shape[-1] - k]
        z = np.where(z < kth, -np.inf, z)
    z = z - z.max()
    p = np.exp(z)
    return p / p.sum()


def _inverse_cdf(p: np.ndarray, u: float) -> int:
    idx = int(np.searchsorted(np.cumsum(p), u, side="right"))
    return min(idx, p.shape[-1] - 1)


def greedy_verify(target_argmax: np.ndarray, drafts: list[int]
                  ) -> tuple[int, list[int]]:
    """Greedy accept rule. ``target_argmax``: [>= k+1] argmax per verify
    row (row j scores the token after window position j); ``drafts``: k
    proposed tokens. Returns (accepted count, emitted tokens): the
    accepted prefix plus the target's token at the first mismatch, or
    the bonus token when every draft matched."""
    emitted: list[int] = []
    for j, d in enumerate(drafts):
        tgt = int(target_argmax[j])
        emitted.append(tgt)
        if int(d) != tgt:
            return j, emitted
    emitted.append(int(target_argmax[len(drafts)]))
    return len(drafts), emitted


def rejection_sample(rows: np.ndarray, drafts: list[int],
                     qdists: np.ndarray | None, temperature: float,
                     top_k: int, seed: int, emit_base: int
                     ) -> tuple[int, list[int]]:
    """Exact accept / reject over one slot's verify window.

    rows: [>= k+1, V] target logits (row j scores the token after window
    position j); drafts: k proposed tokens; qdists: the proposer's
    per-position distributions [k, V], None for a point mass on each
    draft (the n-gram proposer). ``emit_base`` is the emit index of the
    step's first token. Returns (accepted count, emitted tokens)."""
    emitted: list[int] = []
    for j, d in enumerate(drafts):
        d = int(d)
        p = target_dist(rows[j], temperature, top_k)
        key = emit_key(seed, emit_base + j)
        q_d = 1.0 if qdists is None else float(qdists[j][d])
        # a proposer that claims it could not have drawn d: a certain
        # rejection rather than a division by zero
        ratio = 0.0 if q_d <= 0.0 else min(1.0, float(p[d]) / q_d)
        if _uniform(prng.fold_in(key, ACCEPT_SALT)) < ratio:
            emitted.append(d)
            continue
        if qdists is None:
            res = p.copy()
            res[d] = 0.0
        else:
            res = np.maximum(p - qdists[j], 0.0)
        tot = res.sum()
        if tot <= 0.0:     # p == q: the residual is empty and the
            res, tot = p, p.sum()   # acceptance above was certain anyway
        y = _inverse_cdf(res / tot,
                         _uniform(prng.fold_in(key, RESIDUAL_SALT)))
        emitted.append(y)
        return j, emitted
    p = target_dist(rows[len(drafts)], temperature, top_k)
    key = emit_key(seed, emit_base + len(drafts))
    emitted.append(_inverse_cdf(
        p, _uniform(prng.fold_in(key, BONUS_SALT))))
    return len(drafts), emitted
