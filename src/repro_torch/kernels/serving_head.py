"""The serving LM head: plain twin + CUDA kernel wrapper.

``serving_head(h, w, tied=...)`` is the f32 product ``h @ W`` that turns
the final hidden states of a decode step, a verify window or a prefill
chunk's last row into logits (``models.lm._serving_logits``). ``w`` is
the LM head ``[d, V]``, or with ``tied=True`` the embedding ``[V, d]``,
read as it lies.

* ``serving_head_plain`` is ``torch.matmul`` in f32, the product the
  reference's ``common.dense(h, head, compute_dtype=f32)`` computes.
* ``serving_head_cuda`` launches ``csrc/serving_head.cu``, one kernel
  per call: every logit's K-sum runs in one fixed order (k = 0..K-1, one
  fmaf each), so a row's logits are bitwise the same at any number of
  rows M, in any place of the batch. cuBLAS picks its kernel by M, which
  made the speculative verify window (M = slots x window) differ from
  the decode steps (M = slots) it replaces. Up to 16 rows a thread owns
  a column of W and every row; from 17 rows on (the verify window) a
  register-blocked tile of 8 rows x 4 columns a thread, the same chain,
  so the same bits. The kernel agrees with the plain twin to f32
  rounding of a K-term sum, not bitwise.

``serving_head`` dispatches on the device of ``h``: the plain twin for a
CPU tensor, the kernel for a CUDA tensor (or a ``ValueError`` for what
the kernel does not take; there is no fallback).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, traced

def _lib():
    lib = _build.load("serving_head")
    if not getattr(lib, "_typed", False):
        fn = lib.repro_serving_head
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _split(h: torch.Tensor, w: torch.Tensor, tied: bool):
    if w.dim() != 2 or h.shape[-1] != w.shape[1 if tied else 0]:
        raise ValueError(f"serving_head: h {tuple(h.shape)} does not match "
                         f"{'tied [V, d]' if tied else '[d, V]'} weights "
                         f"{tuple(w.shape)}")
    v, d = w.shape if tied else w.shape[::-1]
    return h.reshape(-1, d), d, v


def serving_head_plain(h: torch.Tensor, w: torch.Tensor, *,
                       tied: bool = False) -> torch.Tensor:
    """f32 logits [..., V] = h [..., d] @ W, by ``torch.matmul``."""
    _split(h, w, tied)
    wf = w.to(torch.float32)
    return torch.matmul(h.to(torch.float32), wf.T if tied else wf)


def serving_head_cuda(h: torch.Tensor, w: torch.Tensor, *,
                      tied: bool = False) -> torch.Tensor:
    """Launch ``csrc/serving_head.cu``: f32 logits [..., V], each row's
    bits independent of the rows beside it. ``h`` f32 or bf16 on the
    card, ``w`` f32 and contiguous."""
    return _serving_head(h, w, int(tied))


@traced.kernel("serving_head", "(Tensor h, Tensor w, int tied) -> Tensor")
def _serving_head(h, w, tied):
    rows, d, v = _split(h, w, tied)
    if not (h.is_cuda and w.is_cuda and h.device == w.device):
        raise ValueError("serving_head_cuda takes CUDA tensors on one "
                         f"device, got {h.device} and {w.device}")
    if h.dtype not in (torch.float32, torch.bfloat16) or \
            w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"serving_head_cuda takes f32 / bf16 h and "
                         f"contiguous f32 W, got {h.dtype} and {w.dtype} "
                         f"(contiguous {w.is_contiguous()})")
    m = rows.shape[0]
    if m < 1 or max(m, d, v) >= 2 ** 31 or m * max(d, v) >= 2 ** 62:
        raise ValueError(f"serving_head_cuda: unsupported shape M={m}, "
                         f"d={d}, V={v}")
    rows = rows.contiguous()
    out = torch.empty((m, v), dtype=torch.float32, device=h.device)
    lib = _lib()
    err = lib.repro_serving_head(
        rows.data_ptr(), int(rows.dtype == torch.bfloat16), w.data_ptr(),
        int(tied), out.data_ptr(), m, d, v,
        torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError("serving_head kernel launch failed: "
                           + lib.repro_error_string(err).decode())
    _build.launches["serving_head"] += 1
    return out.reshape(*h.shape[:-1], v)


def serving_head(h: torch.Tensor, w: torch.Tensor, *,
                 tied: bool = False) -> torch.Tensor:
    """f32 logits: the plain twin on the CPU, the kernel on the card."""
    fn = serving_head_cuda if traced.on_card(h) else serving_head_plain
    return fn(h, w, tied=tied)


def bytes_moved(m: int, d: int, v: int, h_bytes: int = 4) -> int:
    """Least HBM traffic of one call: W and h read once, the logits
    written once."""
    return 4 * d * v + h_bytes * m * d + 4 * m * v
