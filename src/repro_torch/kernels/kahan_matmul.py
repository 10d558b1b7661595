"""Matmul with compensated K-block accumulation: plain twins + CUDA
kernel wrappers.

Port of ``repro.kernels.kahan_matmul``. ``C = A @ B`` (and, in the q8
form, ``C = A @ dequant(qw)``): the K axis is cut into blocks of ``bk``,
each block's partial product is an ordinary f32 matmul, and the
partials are folded in block order into a Neumaier (sum, carry) pair;
the result is ``sum + carry`` in f32. The result depends on ``bk``
(``min(block_k, K)``, or ``K // scales.shape[0]`` for q8); ``block_m``
/ ``block_n`` change no number and are only checked to divide the
shapes, as the reference asserts.

* ``kahan_matmul_plain`` / ``kahan_matmul_q8_plain`` follow the
  reference's blocking step by step in PyTorch ops (f32 matmul per K
  block; keep TF32 off on the card, ``device.set_numerics``).
* ``kahan_matmul_cuda`` / ``kahan_matmul_q8_cuda`` launch
  ``csrc/kahan_matmul.cu`` (design and bounds in that file) on one of
  two routes that ``pick_route`` chooses by M: route T (``tile``, M >
  64) runs wgmma on the bf16 tensor cores with f32 operands split into
  three exact bf16 planes; route S (``split``, M <= 64) computes each
  K block's partial in its own CTA and folds them in block order in a
  second kernel.
  Within a K block each sums in its own order, so they agree with the
  twins to f32 rounding of the block partials, not bitwise.
* ``kahan_matmul`` / ``kahan_matmul_q8`` dispatch on A's device.

fp8 weights: ``quantize_weight(w, FP8)`` stores e4m3 bytes as u8. The
reference kernel widens them with ``astype(f32)`` (byte values); the
port widens them as e4m3 (``cast_f32``), so its fp8 path agrees with
``dequantize_weight`` and not with the reference kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import kahan
from repro_torch.kernels import _build, traced
from repro_torch.quant.core import cast_f32


def _block_k(a, b, block_m, block_n, block_k) -> int:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"kahan_matmul takes A [M, K] and B [K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"blocks ({bm}, {bn}, {bk}) must divide "
                         f"(M, N, K) = ({m}, {n}, {k})")
    return bk


def _q8_block_k(a, qw, scales, block_m, block_n) -> int:
    if a.dim() != 2 or qw.dim() != 2 or scales.dim() != 2:
        raise ValueError("kahan_matmul_q8 takes A [M, K], qw [K, N] and "
                         "scales [K // bk, N]")
    (m, k), (k2, n), (nk, n2) = a.shape, qw.shape, scales.shape
    if k != k2 or n != n2 or nk < 1 or k % nk:
        raise ValueError(f"shapes disagree: A {tuple(a.shape)}, qw "
                         f"{tuple(qw.shape)}, scales {tuple(scales.shape)}")
    bm, bn = min(block_m, m), min(block_n, n)
    if m % bm or n % bn:
        raise ValueError(f"blocks ({bm}, {bn}) must divide (M, N) = "
                         f"({m}, {n})")
    return k // nk


def _fold(a, w, bk: int, scales=None) -> torch.Tensor:
    """The reference's K-block loop: f32 partial per block (times the
    block's scales), Neumaier fold, sum + carry."""
    m, k = a.shape
    s = torch.zeros((m, w.shape[1]), dtype=torch.float32, device=a.device)
    c = torch.zeros_like(s)
    for j in range(k // bk):
        part = a[:, j * bk:(j + 1) * bk] @ w[j * bk:(j + 1) * bk]
        if scales is not None:
            part = part * scales[j]
        s, c = kahan.neumaier_step(s, c, part)
    return s + c


def kahan_matmul_plain(a, b, *, block_m: int = 256, block_n: int = 256,
                       block_k: int = 256) -> torch.Tensor:
    """C = A @ B with compensated K-accumulation, in PyTorch ops."""
    bk = _block_k(a, b, block_m, block_n, block_k)
    return _fold(a.to(torch.float32), b.to(torch.float32), bk)


def kahan_matmul_q8_plain(a, qw, scales, *, block_m: int = 256,
                          block_n: int = 256) -> torch.Tensor:
    """C = A @ dequant(qw) with compensated K-accumulation: each block's
    partial against the widened payload times its per-column scales."""
    bk = _q8_block_k(a, qw, scales, block_m, block_n)
    return _fold(a.to(torch.float32), cast_f32(qw), bk, scales)


# ------------------------------------------------------------ CUDA kernel --

SPLIT_MAX_M = 64      # route S (split over K blocks) up to this M
_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2,
          torch.uint8: 3}                             # POOL_* codes


def _lib():
    lib = _build.load("kahan_matmul")
    if not getattr(lib, "_typed", False):
        lib.repro_kahan_matmul_tile.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.repro_kahan_matmul_tile.restype = ctypes.c_int
        lib.repro_kahan_matmul_split.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.repro_kahan_matmul_split.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def pick_route(m: int) -> str:
    """``"split"`` (route S: one CTA per (64 columns, K block, 8 rows),
    then a fold kernel) for M <= ``SPLIT_MAX_M``, else ``"tile"`` (route
    T: wgmma on tiles of 128 rows). Each route counts its launches under
    its own name: ``kahan_matmul`` / ``kahan_matmul_q8`` for tile, with
    ``_split`` appended for split."""
    return "split" if m <= SPLIT_MAX_M else "tile"


def counter(q8: bool, which: str) -> str:
    """The launch counter of a route: ``kahan_matmul[_q8][_split]``."""
    name = "kahan_matmul_q8" if q8 else "kahan_matmul"
    return name + "_split" if which == "split" else name


def _launch(a, b, scales, bk: int, which: str):
    """Launch route ``which`` of ``csrc/kahan_matmul.cu``; returns the
    output and (route S) the block partials it folded, [K / bk, M, N]."""
    for t in (a, b) + (() if scales is None else (scales,)):
        if not t.is_cuda or t.device != a.device or not t.is_contiguous():
            raise ValueError("kahan_matmul kernels take contiguous tensors "
                             "on one CUDA device")
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"A must be f32 or bf16, got {a.dtype}")
    (m, k), n = a.shape, b.shape[1]
    if which == "tile" and -(-m // 128) > 65535:
        raise ValueError(f"M={m} exceeds the grid's 65535 x 128 rows")
    if which == "split" and k // bk > 65535:
        raise ValueError(f"K / bk = {k // bk} exceeds the grid's 65535")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    ws = None
    lib = _lib()
    sp = None if scales is None else scales.data_ptr()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    types = (m, n, k, bk, _TYPES[a.dtype], _TYPES[b.dtype], stream)
    if which == "split":
        ws = torch.empty((k // bk, m, n), dtype=torch.float32,
                         device=a.device)
        err = lib.repro_kahan_matmul_split(
            a.data_ptr(), b.data_ptr(), sp, ws.data_ptr(), out.data_ptr(),
            *types)
    else:
        err = lib.repro_kahan_matmul_tile(
            a.data_ptr(), b.data_ptr(), sp, out.data_ptr(), *types)
    name = counter(scales is not None, which)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.repro_error_string(err).decode())
    _build.launches[name] += 1
    return out, ws


def kahan_matmul_cuda(a, b, *, block_m: int = 256, block_n: int = 256,
                      block_k: int = 256) -> torch.Tensor:
    """Launch ``csrc/kahan_matmul.cu`` on the route ``pick_route`` picks
    by M; same contract as the plain twin (A and B f32 or bf16)."""
    traced.check_real("kahan_matmul", a, b)
    bk = _block_k(a, b, block_m, block_n, block_k)
    if b.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"B must be f32 or bf16, got {b.dtype}")
    return _launch(a, b, None, bk, pick_route(a.shape[0]))[0]


def kahan_matmul_q8_cuda(a, qw, scales, *, block_m: int = 256,
                         block_n: int = 256) -> torch.Tensor:
    """Launch the q8 form of ``csrc/kahan_matmul.cu``: A f32 or bf16, qw
    int8 or u8 (fp8 e4m3 bytes), scales f32."""
    traced.check_real("kahan_matmul_q8", a, qw, scales)
    bk = _q8_block_k(a, qw, scales, block_m, block_n)
    if qw.dtype not in (torch.int8, torch.uint8) or \
            scales.dtype != torch.float32:
        raise ValueError(f"qw must be int8 or u8 (fp8) and scales f32, got "
                         f"{qw.dtype} / {scales.dtype}")
    return _launch(a, qw, scales, bk, pick_route(a.shape[0]))[0]


def split_parts(a, b, bk: int, scales=None):
    """Route S's output and the block partials [K / bk, M, N] it folded
    (each times its scales in the q8 form), so a caller can hold the
    output to a serial fold of the same partials (M <= ``SPLIT_MAX_M``).
    Counted as a launch of the split route."""
    if a.shape[0] > SPLIT_MAX_M:
        raise ValueError(f"route S takes M <= {SPLIT_MAX_M}, got "
                         f"{a.shape[0]}")
    return _launch(a, b, scales, bk, "split")


# ------------------------------------------------------------ dispatch -----

def kahan_matmul(a, b, *, block_m: int = 256, block_n: int = 256,
                 block_k: int = 256) -> torch.Tensor:
    """C = A @ B with compensated K-accumulation -> f32 [M, N]: the plain
    twin for a CPU tensor, the kernel for a CUDA tensor."""
    fn = kahan_matmul_cuda if a.is_cuda else kahan_matmul_plain
    return fn(a, b, block_m=block_m, block_n=block_n, block_k=block_k)


def kahan_matmul_q8(a, qw, scales, *, block_m: int = 256,
                    block_n: int = 256) -> torch.Tensor:
    """C = A @ dequant(qw) with compensated f32 K-accumulation; ``qw`` /
    ``scales`` from ``quant.core.quantize_weight`` (its K block is the
    fold's K block)."""
    fn = kahan_matmul_q8_cuda if a.is_cuda else kahan_matmul_q8_plain
    return fn(a, qw, scales, block_m=block_m, block_n=block_n)


def tensor_passes(a_dtype, b_dtype) -> int:
    """bf16 tensor-core products route T issues per k16 step: 1 for
    one-plane operands (bf16, int8, fp8), 3 when one side is f32 (three
    planes), 6 for f32 x f32 (the products of plane indices i + j <= 2)."""
    planes = [3 if d == torch.float32 else 1 for d in (a_dtype, b_dtype)]
    return 6 if planes == [3, 3] else planes[0] * planes[1]


def flops(m: int, n: int, k: int, bk: int, scaled: bool = False) -> tuple:
    """(multiply-add flops, f32 fold flops) of one call: 2 M N K for the
    products, and per output and K block a TwoSum and a carry add (7),
    plus the scale multiply in the q8 form."""
    return 2 * m * n * k, m * n * (k // bk) * (8 if scaled else 7)


def bytes_moved(*tensors, out_elems: int) -> int:
    """Least HBM traffic: every input once, the f32 output once."""
    return sum(t.numel() * t.element_size() for t in tensors) + 4 * out_elems


# ------------------------------------------- the deep accuracy case -------

def deep_case(m: int = 8):
    """An ill-conditioned contraction deep in K (numpy f32 A [m, 2^14], B
    [2^14, 8], magnitudes 1e-3..1e3 per K index, seed 1): the case that
    holds route T's compensation to the reference's at bk = 128."""
    import numpy as np
    rng = np.random.default_rng(1)
    n, k = 8, 1 << 14
    scales = 10.0 ** rng.integers(-3, 4, (1, k))
    a = (rng.standard_normal((m, k)) * scales).astype(np.float32)
    b = (rng.standard_normal((k, n)) * scales.T).astype(np.float32)
    return a, b


# max |C - exact| of the reference ``repro.kernels.kahan_matmul.kahan_matmul
# (..., block_m=M, block_n=8, block_k=128, interpret=True)`` on
# ``deep_case(M)``, measured on the CPU (XLA) and pinned by
# tests/test_torch_kahan_matmul.py::test_reference_deep_error_is_pinned;
# the card cannot run the reference, so its checks read these
DEEP_CASE_REFERENCE_ERR = {8: 11.246876902878284, 72: 14.656442247331142}

# the same for f32 A against ``deep_case(M)``'s B quantized per 128-row K
# block (``quant.core.quantize_weight``), |C - A @ dequant(B)|: the
# reference ``kahan_matmul_q8(..., block_m=M, block_n=8, interpret=True)``
# (an fp8 payload passed as float8_e4m3fn, which it widens as e4m3),
# pinned by
# tests/test_torch_kahan_matmul.py::test_reference_deep_q8_error_is_pinned
DEEP_CASE_Q8_REFERENCE_ERR = {("int8", 8): 10.809860930778086,
                              ("fp8", 8): 10.453886933624744,
                              ("int8", 72): 12.10521353292279,
                              ("fp8", 72): 20.533587262034416}
