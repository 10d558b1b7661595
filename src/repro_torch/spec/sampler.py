"""Accept rule for speculative decoding (the greedy half of
``repro.spec.sampler``).

Greedy requests keep the classic argmax-prefix rule: accept drafts while
they equal the target's argmax, then emit the target's own choice, so
the emitted stream is the non-speculative greedy stream.

Exact rejection sampling of sampled requests (``rejection_sample``,
``target_dist``, ``emit_key`` and the role salts) waits for the keyed
RNG, ROADMAP queue A item 4: every draw there is keyed on
``jax.random.fold_in``, whose bits the port must reproduce first.
"""

from __future__ import annotations

import numpy as np


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
