"""PyTorch / CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

Each module here has a twin at the same relative path under ``repro``
(the JAX reference, which this package never imports). Plain tensor code
is PyTorch; the Pallas TPU kernels of the served paths are hand-written
CUDA C++ for ``sm_90a`` under ``csrc/``, each with a plain PyTorch twin
beside its wrapper:

* ``kernels/paged_attention.py`` + ``csrc/paged_attention.cu`` — the
  paged-attention superkernel (GQA form);
* ``kernels/paged_attention.py`` + ``csrc/paged_latent_attention.cu`` —
  the same superkernel's MLA latent form (both include the shared
  compensation helpers of ``csrc/superkernel_common.cuh``);
* ``kernels/engine.py`` + ``csrc/fused_reduce.cu`` — the compensated
  multi-output row-reduction engine.

Entry points run on the card unless the caller passes ``device="cpu"``
(see ``repro_torch.device``). On a CPU tensor a kernel wrapper runs its
plain twin; on a CUDA tensor it launches the kernel or raises.
"""
