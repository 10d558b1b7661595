"""The port's kernels: hand-written CUDA for Hopper (``csrc/*.cu``, built
by ``_build``) behind wrappers that dispatch on the input's device (the
plain PyTorch twin for a CPU tensor, the kernel for a CUDA tensor).

Public entry points (those of ``repro.kernels``):

  ops.kahan_dot / kahan_sum      compensated reductions (engine-backed)
  ops.naive_dot                  the paper's baseline (engine, no carry)
  ops.fused_reduce               one pass -> {dot,sum,sumsq,max,maxabs}
  ops.batched_fused_reduce       (B, N) -> per-row statistic family
  ops.batched_kahan_dot          many independent dots per call
  ops.kahan_accumulate           elementwise compensated accumulate,
                                 in place
  ops.paged_attention            the paged-attention superkernel (GQA
                                 and MLA latent forms)
  ops.q8_matmul                  int8 / fp8 weight matmul, compensated
                                 K-accumulation
  kahan_matmul                   compensated K-block matmul
  flash_attention                online-softmax attention, ragged and
                                 optionally causal (top-left)

``kahan_matmul`` and ``flash_attention`` are the functions; their
modules are ``repro_torch.kernels.kahan_matmul`` and
``repro_torch.kernels.flash_attention`` in ``sys.modules`` (import names
from them directly). The ``*_blocked`` shims live in ``kahan_dot``,
``kahan_sum`` and ``naive_dot``; ``ref`` holds the plain oracles.
"""

from repro_torch.kernels import engine, ops, ref  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.kahan_matmul import kahan_matmul  # noqa: F401
from repro_torch.kernels.paged_attention import (  # noqa: F401
    paged_attention_cuda, paged_attention_plain, paged_latent_attention_cuda,
    paged_latent_attention_plain)
