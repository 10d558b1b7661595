"""Elementwise compensated accumulate: plain twin + CUDA kernel wrapper.

Port of ``repro.kernels.kahan_acc`` (the gradient-accumulation form of
the paper's algorithm): a (sum, carry) pair per element folds in each
new update with one Neumaier step, ``update`` widened to the
accumulator's dtype. The TPU kernel aliases its outputs onto its inputs
(``input_output_aliases={0: 0, 1: 1}``); here both forms update
``acc_sum`` / ``acc_carry`` IN PLACE and return the same two tensors, so
a call moves 20 bytes per f32 element and allocates nothing.

* ``kahan_acc_flat_plain``: the reference's op sequence in PyTorch
  (bitwise the reference: adds only).
* ``kahan_acc_flat_cuda``: launches ``csrc/kahan_acc.cu`` (bitwise the
  twin). f32 accumulators only (anything else raises ``ValueError``);
  the update may be f32 or bf16.
* ``kahan_acc_flat`` dispatches on the accumulator's device;
  ``kahan_acc_blocked`` is the (M, 128) shim over it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import kahan
from repro_torch.kernels import _build, traced
from repro_torch.kernels.engine import LANES

_MAX_BLOCKS = 132 * 8            # H100 SXM: 132 SMs, 8 blocks of 256 each


def _check(acc_sum, acc_carry, update, flat: bool) -> None:
    if not acc_sum.shape == acc_carry.shape == update.shape:
        raise ValueError(f"shapes differ: {tuple(acc_sum.shape)}, "
                         f"{tuple(acc_carry.shape)}, {tuple(update.shape)}")
    if flat and acc_sum.dim() != 1:
        raise ValueError(f"kahan_acc_flat takes 1-D tensors, got "
                         f"{tuple(acc_sum.shape)}")


def kahan_acc_flat_plain(acc_sum, acc_carry, update):
    """One Neumaier step per element, written back in place."""
    _check(acc_sum, acc_carry, update, flat=False)
    s, c = kahan.neumaier_step(acc_sum, acc_carry, update.to(acc_sum.dtype))
    acc_sum.copy_(s)
    acc_carry.copy_(c)
    return acc_sum, acc_carry


def _lib():
    lib = _build.load("kahan_acc")
    if not getattr(lib, "_typed", False):
        fn = lib.repro_kahan_acc
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def kahan_acc_flat_cuda(acc_sum, acc_carry, update):
    """Launch ``csrc/kahan_acc.cu`` on contiguous CUDA tensors of any
    shape (elementwise); same contract as the plain twin."""
    _check(acc_sum, acc_carry, update, flat=False)
    _kahan_acc(acc_sum, acc_carry, update)
    return acc_sum, acc_carry


@traced.kernel("kahan_acc", "(Tensor(a!) acc_sum, Tensor(b!) acc_carry, "
               "Tensor update) -> ()", mutates=("acc_sum", "acc_carry"))
def _kahan_acc(acc_sum, acc_carry, update):
    dev = acc_sum.device
    for t in (acc_sum, acc_carry, update):
        if not t.is_cuda or t.device != dev or not t.is_contiguous():
            raise ValueError("kahan_acc_flat_cuda takes contiguous tensors "
                             "on one CUDA device")
    if acc_sum.dtype != torch.float32 or acc_carry.dtype != torch.float32:
        raise ValueError(f"kahan_acc_flat_cuda takes f32 accumulators, got "
                         f"{acc_sum.dtype}/{acc_carry.dtype}")
    if update.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"update must be f32 or bf16, got {update.dtype}")
    bf16 = update.dtype == torch.bfloat16
    vec = (acc_sum.data_ptr() % 16 == 0 and acc_carry.data_ptr() % 16 == 0
           and update.data_ptr() % (8 if bf16 else 16) == 0)
    lib = _lib()
    err = lib.repro_kahan_acc(acc_sum.data_ptr(), acc_carry.data_ptr(),
                              update.data_ptr(), acc_sum.numel(), int(bf16),
                              int(vec), _MAX_BLOCKS,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("kahan_acc kernel launch failed: "
                           + lib.repro_error_string(err).decode())
    _build.launches["kahan_acc"] += 1


def kahan_acc_flat(acc_sum, acc_carry, update):
    """Flat 1-D compensated accumulate, in place: the plain twin for a
    CPU tensor, the kernel for a CUDA tensor. Returns (acc_sum,
    acc_carry)."""
    _check(acc_sum, acc_carry, update, flat=True)
    if traced.on_card(acc_sum):
        return kahan_acc_flat_cuda(acc_sum, acc_carry, update)
    return kahan_acc_flat_plain(acc_sum, acc_carry, update)


def kahan_acc_blocked(acc_sum, acc_carry, update):
    """(M, 128) compensated accumulate (the legacy 2-D entry point), in
    place through flat views."""
    if acc_sum.dim() != 2 or acc_sum.shape[1] != LANES:
        raise ValueError(f"kahan_acc_blocked takes (M, {LANES}), got "
                         f"{tuple(acc_sum.shape)}")
    kahan_acc_flat(acc_sum.view(-1), acc_carry.view(-1), update.reshape(-1))
    return acc_sum, acc_carry


def bytes_moved(n: int, update_itemsize: int = 4) -> int:
    """Least HBM traffic of one call over n f32 elements: sum, carry and
    update read once, sum and carry written once."""
    return n * (4 * 4 + update_itemsize)
