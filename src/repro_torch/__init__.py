"""PyTorch / CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

Each module here has a twin at the same relative path under ``repro``
(the JAX reference, which this package never imports). Plain tensor code
is PyTorch; the two Pallas TPU kernels of the serving main path are
hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, each with a plain
PyTorch twin beside its wrapper:

* ``kernels/paged_attention.py`` + ``csrc/paged_attention.cu`` — the
  paged-attention superkernel (GQA form);
* ``kernels/engine.py`` + ``csrc/fused_reduce.cu`` — the compensated
  multi-output row-reduction engine.

Entry points run on the card unless the caller passes ``device="cpu"``
(see ``repro_torch.device``). On a CPU tensor a kernel wrapper runs its
plain twin; on a CUDA tensor it launches the kernel or raises.
"""
