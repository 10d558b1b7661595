"""Compensated fused multi-reduction: plain twin + CUDA kernel wrapper.

Port of ``repro.kernels.engine`` (the paper's unrolled multi-stream
Kahan/Neumaier reduction). One pass over the operands emits any subset of
``dot``/``sum``/``sumsq`` (compensated, or plain with
``compensated=False``) and ``max``/``maxabs``.

* ``fused_reduce_rows_plain`` / ``fused_reduce_flat_plain`` mirror the
  reference's stream layout exactly: ``pick_block_elems`` blocks, each
  reshaped to ``(U, chunks, 8, 128)`` Neumaier streams that persist across
  blocks, then a TwoSum fold over streams, sublanes and lanes. The
  compensated outputs are therefore bitwise the reference's.
* ``fused_reduce_rows_cuda`` launches ``csrc/fused_reduce.cu`` (design and
  bound in that file). Its stream layout is the GPU's own (per-thread
  streams, TwoSum block and split folds), so it agrees with the plain
  twin to the compensated-sum error bound, not bitwise.

``fused_reduce_rows`` / ``fused_reduce_flat`` dispatch on the operand's
device: the plain twin for a CPU tensor, the kernel for a CUDA tensor.
The flat form is the kernel at B = 1.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import kahan
from repro_torch.kernels import _build

SUBLANES = 8
LANES = 128
TILE = SUBLANES * LANES

COMPENSATED_OUTPUTS = ("dot", "sum", "sumsq")
MAX_OUTPUTS = ("max", "maxabs")
ALL_OUTPUTS = COMPENSATED_OUTPUTS + MAX_OUTPUTS

DEFAULT_UNROLL = {"dot": 4, "sum": 4, "sumsq": 4, None: 4}
DEFAULT_BLOCK_ELEMS = 32 * TILE

_SLOT = {o: i for i, o in enumerate(ALL_OUTPUTS)}   # kernel output rows
_SMS = 132                                          # H100 SXM
_THREADS = 256
_MIN_SPLIT_ELEMS = _THREADS * 16


def default_unroll(outputs) -> int:
    for o in outputs:
        if o in COMPENSATED_OUTPUTS:
            return DEFAULT_UNROLL[o]
    return DEFAULT_UNROLL[None]


def check_outputs(outputs, n_operands: int) -> tuple[str, ...]:
    outputs = tuple(outputs)
    if not outputs:
        raise ValueError("need at least one output")
    for o in outputs:
        if o not in ALL_OUTPUTS:
            raise ValueError(f"unknown output {o!r}; known: {ALL_OUTPUTS}")
    if "dot" in outputs and n_operands != 2:
        raise ValueError("'dot' needs two operands")
    return outputs


def pick_block_elems(n: int, unroll: int) -> int:
    """Largest block <= ~DEFAULT_BLOCK_ELEMS, an exact multiple of
    unroll * TILE (the reference's stream granule); halves while a block
    would cover more than twice the input."""
    floor = unroll * TILE
    k = max(DEFAULT_BLOCK_ELEMS // floor, 1)
    while k > 1 and k * floor >= 2 * max(n, 1):
        k //= 2
    return k * floor


# ------------------------------------------------------------ plain twin ---

def _binary_fold_axis(s, c, axis: int):
    """Halve ``axis`` repeatedly, merging (sum, carry) pairs with TwoSum."""
    size = s.shape[axis]
    while size > 1:
        half = size // 2
        s, c = kahan.combine(s.narrow(axis, 0, half), c.narrow(axis, 0, half),
                             s.narrow(axis, half, size - half),
                             c.narrow(axis, half, size - half))
        size = half
    return s, c


def fused_reduce_rows_plain(operands, *, outputs,
                            compensated: bool = True) -> tuple:
    """(B, N) operands -> tuple of (B,) tensors, in the reference's order
    (its default unroll and block schedule)."""
    operands = tuple(operands)
    outputs = check_outputs(outputs, len(operands))
    b, n = operands[0].shape
    unroll = default_unroll(outputs)
    block_elems = pick_block_elems(n, unroll)
    acc = torch.promote_types(operands[0].dtype, torch.float32)
    nblk = -(-n // block_elems)
    pad = nblk * block_elems - n
    # the reference masks the tail block to exact zeros before any use
    ops = [F.pad(op.to(acc), (0, pad)) for op in operands]
    x = ops[0]
    chunks = block_elems // (unroll * TILE)
    out = {}
    for o in outputs:
        if o in MAX_OUTPUTS:
            if o == "max":
                out[o] = torch.amax(operands[0].to(acc), dim=1)
            else:
                out[o] = torch.amax(torch.abs(x), dim=1)
            continue
        contrib = {"dot": lambda: x * ops[1], "sum": lambda: x,
                   "sumsq": lambda: x * x}[o]()
        if not compensated:
            parts = contrib.reshape(b, nblk, -1, SUBLANES, LANES)
            s = torch.zeros((b, SUBLANES, LANES), dtype=acc, device=x.device)
            for j in range(nblk):
                s = s + parts[:, j].sum(dim=1)
            out[o] = s.sum(dim=(1, 2))
            continue
        r = contrib.reshape(b, nblk, unroll, chunks, SUBLANES, LANES)
        s = torch.zeros((b, unroll, SUBLANES, LANES), dtype=acc,
                        device=x.device)
        c = torch.zeros_like(s)
        for j in range(nblk):
            for i in range(chunks):
                s, c = kahan.neumaier_step(s, c, r[:, j, :, i])
        for axis in (1, 2, 3):            # streams, sublanes, lanes
            s, c = _binary_fold_axis(s, c, axis)
        out[o] = (s + c).reshape(b)
    return tuple(out[o] for o in outputs)


def fused_reduce_flat_plain(operands, **kw) -> tuple:
    """(N,) operands -> tuple of 0-d tensors (the rows form at B = 1)."""
    outs = fused_reduce_rows_plain(tuple(op.reshape(1, -1)
                                         for op in operands), **kw)
    return tuple(o[0] for o in outs)


# ------------------------------------------------------------ CUDA kernel --

def _lib():
    lib = _build.load("fused_reduce")
    if not getattr(lib, "_typed", False):
        fn = lib.repro_fused_reduce_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def splits(rows: int, n: int) -> tuple[int, int]:
    """(S, seg): splits per row so that rows * S covers the SMs a few
    times over without making a split shorter than 4096 elements; ``seg``
    is a multiple of 4 so splits start on 16-byte boundaries."""
    s = max(1, min(-(-4 * _SMS // rows), -(-n // _MIN_SPLIT_ELEMS)))
    seg = -(-(-(-n // s)) // 4) * 4
    return -(-n // seg), seg


def fused_reduce_rows_cuda(operands, *, outputs,
                           compensated: bool = True) -> tuple:
    """Launch ``csrc/fused_reduce.cu`` on (B, N) f32 CUDA operands."""
    operands = tuple(operands)
    outputs = check_outputs(outputs, len(operands))
    x = operands[0]
    for op in operands:
        if not op.is_cuda or op.dtype != torch.float32 or op.dim() != 2:
            raise ValueError("fused_reduce_rows_cuda takes 2-D f32 CUDA "
                             f"tensors, got {op.dtype} {tuple(op.shape)} "
                             f"on {op.device}")
        if op.shape != x.shape or not op.is_contiguous():
            raise ValueError("operands must be contiguous and same-shape")
    b, n = x.shape
    if n < 1 or b < 1 or b > 65535:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    flags = 0
    for o in outputs:
        flags |= 1 << _SLOT[o]
    nsplit, seg = splits(b, n)
    part = torch.empty((len(ALL_OUTPUTS), b, nsplit, 2), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((len(ALL_OUTPUTS), b), dtype=torch.float32,
                      device=x.device)
    y = operands[1] if len(operands) == 2 else None
    lib = _lib()
    err = lib.repro_fused_reduce_rows(
        x.data_ptr(), None if y is None else y.data_ptr(), b, n, nsplit, seg,
        flags, int(compensated), part.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("fused_reduce kernel launch failed: "
                           + lib.repro_error_string(err).decode())
    _build.launches["fused_reduce"] += 1
    return tuple(out[_SLOT[o]] for o in outputs)


# ------------------------------------------------------------ dispatch -----

def fused_reduce_rows(operands, *, outputs,
                      compensated: bool = True) -> tuple:
    """(B, N) -> tuple of (B,): plain twin on CPU, the kernel on CUDA."""
    operands = tuple(operands)
    if operands[0].is_cuda:
        return fused_reduce_rows_cuda(operands, outputs=outputs,
                                      compensated=compensated)
    return fused_reduce_rows_plain(operands, outputs=outputs,
                                   compensated=compensated)


def fused_reduce_flat(operands, *, outputs,
                      compensated: bool = True) -> tuple:
    """(N,) -> tuple of 0-d tensors: the rows form at B = 1."""
    outs = fused_reduce_rows(tuple(op.reshape(1, -1) for op in operands),
                             outputs=outputs, compensated=compensated)
    return tuple(o[0] for o in outs)


def bytes_moved(rows: int, n: int, n_operands: int, n_outputs: int) -> int:
    """Least HBM traffic of one call: every input read once, every output
    written once (the kernel's bound in ``csrc/fused_reduce.cu``)."""
    return 4 * (rows * n * n_operands + rows * n_outputs)
