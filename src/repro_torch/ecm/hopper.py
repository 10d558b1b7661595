"""Forecasts priced on the H100 (the port's counterpart of the
reference's ``repro.ecm.tpu`` forecasts, in part)."""

from __future__ import annotations

from repro_torch.ecm.machines import H100_SXM


def predicted_restore_vs_reprefill(tokens: int, token_bytes: float,
                                   flops_per_token: float,
                                   hw: dict = H100_SXM) -> float:
    """Time to re-prefill ``tokens`` over the time to restore their KV
    snapshot from host memory; > 1 means restoring wins.

    Both paths end with ``tokens * token_bytes`` of KV resident in HBM, so
    that write is common and the comparison is

        T_restore   = tokens * token_bytes / host_link_bw
        T_reprefill = max(tokens * flops_per_token / peak_flops,
                          tokens * token_bytes / hbm_bw)

    ``token_bytes`` is the engine's per-token pool bytes
    (``KVCache.token_bytes``), so quantized pools shrink the restore side;
    ``flops_per_token`` is ~2 * n_params for a dense forward pass. Both
    sides are linear in ``tokens``, so the ratio does not depend on it.
    """
    if tokens <= 0 or token_bytes <= 0 or flops_per_token <= 0:
        raise ValueError("tokens, token_bytes and flops_per_token must "
                         "be positive")
    t_restore = tokens * token_bytes / hw["host_link_bw"]
    t_reprefill = max(tokens * flops_per_token / hw["peak_flops"],
                      tokens * token_bytes / hw["hbm_bw"])
    return t_reprefill / t_restore
