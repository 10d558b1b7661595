"""ECM on the H100: when is compensation free, and what the serving
forecasts predict (the role ``repro.ecm.tpu`` plays for the reference).

On the card the copy engines and the load/store path run asynchronously
with the CUDA cores and the tensor cores across the ~2000 resident warps,
so the per-level ECM prediction degenerates to the overlap form the
paper derives for saturated multicore operation:

    T = max(T_compute, T_hbm)

a roofline per kernel. ``predict`` evaluates it for the streaming
reduction kernels (naive vs compensated) and ``kahan_overhead`` answers
the paper's central question, what compensation costs, at the card's HBM
rate. No unroll term: the port's reduction kernel (B2 / B2f,
``csrc/fused_reduce.cu``) keeps one Neumaier chain per thread over tens
of thousands of threads, far more independent chains than the FP32
pipes' latency needs.

Every figure comes from ``machines.H100_SXM`` (the data sheet at the
full 700 W limit, or measured on an NVIDIA H100 80GB HBM3 at a 700.00 W
power limit). The first residual this model meets: B2f, the paper's
Kahan dot on 2^24 f32 pairs, ran 0.0571 ms compensated and 0.0568 ms in
the same kernel's naive mode, 1.006 (``chip_smoke.py``'s times phase,
NVIDIA H100 80GB HBM3, 700.00 W), where ``kahan_overhead()`` predicts
1.0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.ecm.machines import H100_SXM


@dataclass(frozen=True)
class StreamSpec:
    """A streaming kernel: HBM bytes and CUDA-core f32 flops per update."""
    name: str
    bytes_per_update: float
    flops_per_update: float

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops_per_update / self.bytes_per_update


# The reduction kernels, f32 elements; a Neumaier step is TwoSum (6 ops)
# plus the carry add (1): the same counts as the reference's.
NAIVE_DOT = StreamSpec("naive_dot", bytes_per_update=8, flops_per_update=2)
KAHAN_DOT = StreamSpec("kahan_dot", bytes_per_update=8, flops_per_update=8)
NAIVE_SUM = StreamSpec("naive_sum", bytes_per_update=4, flops_per_update=1)
KAHAN_SUM = StreamSpec("kahan_sum", bytes_per_update=4, flops_per_update=7)
# gradient accumulation (B7): naive reads sum and grad and writes sum
# (12 B); compensated reads sum, carry and grad and writes sum and carry
# (20 B)
NAIVE_ACC = StreamSpec("naive_acc", bytes_per_update=12, flops_per_update=1)
KAHAN_ACC = StreamSpec("kahan_acc", bytes_per_update=20, flops_per_update=7)
# fused dot + sum + sumsq + max / maxabs in one pass (B2, B2f): the dot's
# 8 B per update, ~3x its work
FUSED_DOT_STATS = StreamSpec("fused_dot_stats", bytes_per_update=8,
                             flops_per_update=25)

STREAM_KERNELS = [NAIVE_DOT, KAHAN_DOT, NAIVE_SUM, KAHAN_SUM, NAIVE_ACC,
                  KAHAN_ACC, FUSED_DOT_STATS]


@dataclass(frozen=True)
class StreamPrediction:
    kernel: str
    t_compute_s: float         # per update, CUDA-core f32
    t_data_s: float            # per update, HBM
    bound: str                 # "compute" | "data"
    updates_per_s: float


def predict(kernel: StreamSpec, hw: dict = H100_SXM) -> StreamPrediction:
    """T = max(T_compute, T_hbm) per update (the full-overlap ECM form)."""
    t_c = kernel.flops_per_update / hw["f32_flops"]
    t_d = kernel.bytes_per_update / hw["hbm_bw"]
    return StreamPrediction(kernel.name, t_c, t_d,
                            "data" if t_d >= t_c else "compute",
                            1.0 / max(t_c, t_d))


def kahan_overhead(naive: StreamSpec = NAIVE_DOT,
                   comp: StreamSpec = KAHAN_DOT,
                   hw: dict = H100_SXM) -> float:
    """Throughput ratio naive / compensated (1.0: compensation is free).
    The compensated dot needs 8 flops per 8 bytes, intensity 1, against a
    ridge of f32_flops / hbm_bw = 20 flops per byte, so both kernels
    stream at the HBM rate and the ratio is 1.0."""
    return predict(naive, hw).updates_per_s / predict(comp, hw).updates_per_s


def predicted_runtime_s(kernel: StreamSpec, n_elems: int,
                        hw: dict = H100_SXM) -> float:
    """The forecast time of an ``n_elems``-update streaming kernel."""
    return n_elems / predict(kernel, hw).updates_per_s


def ridge_flops_per_byte(hw: dict = H100_SXM) -> float:
    """Flops per byte at which CUDA-core f32 work stops being HBM-bound."""
    return hw["f32_flops"] / hw["hbm_bw"]


# ---------------------------------------------------- quantized KV decode --
#
# The paged decode walk (B1, B3) streams each resident sequence's KV once
# per step. Per cached element: ~2 flops for the q.k score and ~2 for the
# p.v fold; a quantized pool adds dequant work. B1 and B3 fold the scales
# after the dot ("folded"): ~1 multiply per element for int8, plus the
# e4m3 widening's 3 integer ops for fp8.

DECODE_FLOPS_PER_KV_ELEM = 4.0
DEQUANT_FLOPS = {"bf16": 0.0, "int8": 1.0, "fp8": 3.0}


def paged_decode_spec(kv_dtype: str, vec_len: int = 64) -> StreamSpec:
    """The paged decode walk per cached KV element; ``vec_len`` is the
    length a 4-byte f32 scale amortizes over (head_dim for GQA pools, the
    latent width for MLA)."""
    from repro_torch.quant.core import kv_bytes_per_value
    return StreamSpec(f"paged_decode_{kv_dtype}",
                      kv_bytes_per_value(kv_dtype, vec_len),
                      DECODE_FLOPS_PER_KV_ELEM + DEQUANT_FLOPS[kv_dtype])


def predicted_decode_speedup(kv_dtype: str, vec_len: int = 64,
                             hw: dict = H100_SXM) -> float:
    """Forecast decode-attention speedup of a quantized KV pool over bf16
    (> 1: faster): max(T_data, T_compute) per format, which on the card
    stays the byte ratio (every format's walk is HBM-bound: ~1.88x for
    int8 and fp8 at head_dim 64)."""
    base = predict(paged_decode_spec("bf16", vec_len), hw)
    quant = predict(paged_decode_spec(kv_dtype, vec_len), hw)
    return quant.updates_per_s / base.updates_per_s


# ------------------------------------------- prefix caching, speculation --

def predicted_prefill_speedup(hit_rate: float, *,
                              prompt_tokens: float | None = None,
                              chunk_tokens: int | None = None) -> float:
    """Prefill-token reduction from prefix caching: 1 / (1 - hit_rate),
    or, with ``prompt_tokens`` and ``chunk_tokens``, the ratio of cold to
    residual chunk launches (the engine prefills whole chunks)."""
    if not 0.0 <= hit_rate < 1.0:
        raise ValueError(f"hit rate must be in [0, 1), got {hit_rate}")
    if prompt_tokens and chunk_tokens:
        cold = math.ceil(prompt_tokens / chunk_tokens)
        warm = math.ceil(prompt_tokens * (1.0 - hit_rate) / chunk_tokens)
        return cold / max(warm, 1)
    return 1.0 / (1.0 - hit_rate)


def expected_accepted_length(alpha: float, k: int) -> float:
    """Tokens emitted per verify walk when each draft is accepted i.i.d.
    with probability ``alpha``: 1 + alpha + ... + alpha^k."""
    return float(sum(alpha ** i for i in range(k + 1)))


def predicted_spec_speedup(alpha: float, k: int, *,
                           draft_byte_ratio: float = 0.0,
                           context_len: int | None = None) -> float:
    """Speculative tok/s over plain paged decode: E(alpha, k) tokens per
    one target verify walk plus k + 1 draft walks of relative cost
    ``draft_byte_ratio`` (0 for the n-gram proposer); ``context_len``
    adds the window's own growth, (L + (k + 1) / 2) / L."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"acceptance rate must be in [0, 1], got {alpha}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    verify_walk = 1.0
    if context_len:
        verify_walk = (context_len + (k + 1) / 2) / context_len
    return expected_accepted_length(alpha, k) / (
        verify_walk + (k + 1) * draft_byte_ratio)


# ------------------------------------------------- preemption, spill tier --

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


def predicted_session_prefill_reduction(
        hit_rate: float, *, promote_ratio: float = float("inf"),
        promoted_fraction: float = 0.0,
        prompt_tokens: float | None = None,
        chunk_tokens: int | None = None) -> float:
    """Session-KV prefill-token reduction behind the promote gate: below
    the crossover (``promote_ratio`` <= 1) the spilled share of the hit,
    ``promoted_fraction``, is re-prefilled instead of promoted, so the
    effective hit rate shrinks by it; the rest is
    ``predicted_prefill_speedup``."""
    if not 0.0 <= promoted_fraction <= hit_rate:
        raise ValueError(
            f"promoted_fraction must be in [0, hit_rate={hit_rate}], "
            f"got {promoted_fraction}")
    effective = (hit_rate if promote_ratio > 1.0
                 else hit_rate - promoted_fraction)
    return predicted_prefill_speedup(effective, prompt_tokens=prompt_tokens,
                                     chunk_tokens=chunk_tokens)


def restore_crossover_flops_per_token(token_bytes: float,
                                      hw: dict = H100_SXM) -> float:
    """FLOPs per prefill token (~2 * n_params) above which restoring a
    preempted request beats re-prefilling it, in the compute-bound regime:
    token_bytes * peak_flops / host_link_bw. On the H100 with bf16 pools
    of full-width qwen1.5 (98 304 B per token) that is ~1.96 GFLOP per
    token, ~978 M parameters: qwen1.5-0.5b's 620 M sit below it, so
    re-prefill wins and ``promote="auto"`` does not promote."""
    if token_bytes <= 0:
        raise ValueError("token_bytes must be positive")
    return token_bytes * hw["peak_flops"] / hw["host_link_bw"]
