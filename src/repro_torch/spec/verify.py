"""Draft-window packing for the batched verify pass (twin of
``repro.spec.verify``).

The spec engine verifies every decoding slot's draft window in ONE call
of ``repro_torch.models.api.verify_fn`` (tokens [S, C], per-slot
offsets). Windows are packed into a fixed [max_slots, spec_k + 1] frame:

- column 0 is the slot's pending token (the last emitted, not yet cached
  token: what a decode step would feed), columns 1..k its drafts, the
  tail padded with the last window token;
- unused rows duplicate row 0. Their writes go to the null block
  (``paged.scatter_chunk_multi`` with ``paged.first_occurrence``) and
  their outputs are ignored.

Padding costs only wasted lanes: a padded column can only write at
positions past the slot's accepted length (masked by ``len`` and
overwritten by the next append, or sent to the null block past the
table), and the causal mask keeps every valid row's scores independent
of them. Acceptance reads only the first k+1 columns of real rows.
"""

from __future__ import annotations

import numpy as np


def pack_windows(reqs: list, ks: list[int], drafts: list[list[int]],
                 max_slots: int, window: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack per-request draft windows into the fixed verify frame.

    Returns (tokens [max_slots, window], slots [max_slots], pos0s
    [max_slots]) as int32; row i < len(reqs) belongs to reqs[i], later
    rows duplicate row 0. ``pos0s`` is each slot's cached length (prompt
    + emitted - 1: the pending token is not cached yet), where the window
    lands."""
    if not reqs or len(reqs) > max_slots:
        raise ValueError(f"{len(reqs)} windows for {max_slots} slots")
    tokens = np.zeros((max_slots, window), np.int32)
    slots = np.zeros((max_slots,), np.int32)
    pos0s = np.zeros((max_slots,), np.int32)
    for i, (req, k) in enumerate(zip(reqs, ks)):
        if not 0 <= k < window or len(drafts[i]) < k:
            raise ValueError(f"request {req.rid}: k = {k} with "
                             f"{len(drafts[i])} drafts in a {window}-wide "
                             f"window")
        win = [req.output[-1]] + [int(t) for t in drafts[i][:k]]
        win += [win[-1]] * (window - len(win))
        tokens[i] = win
        slots[i] = req.slot
        pos0s[i] = req.prefill_pos + len(req.output) - 1
    tokens[len(reqs):] = tokens[0]
    slots[len(reqs):] = slots[0]
    pos0s[len(reqs):] = pos0s[0]
    return tokens, slots, pos0s
