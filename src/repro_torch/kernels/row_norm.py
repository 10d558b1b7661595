"""The row norms of the served paths: plain twins + CUDA kernel wrapper.

``rms_norm(x, w, eps)`` and ``layer_norm(x, w, b, eps)`` normalise each
row of ``x`` [..., d] in f32 and round the result to ``x``'s dtype, as
the reference's ``repro.models.common`` norms do.

* ``rms_norm_plain`` / ``layer_norm_plain`` are the eager PyTorch ops
  the port ran before: torch's row mean, whose sum order on the card
  depends on the number of rows.
* ``row_norm_cuda`` launches ``csrc/row_norm.cu``, one kernel per call:
  each row's sums in one fixed order that depends on d alone, so a row's
  output is bitwise the same at any number of rows M, in any place of
  the batch. Two routes walk that order (``plan``): a warp per row, four
  rows a CTA, for d up to 1024; a group of threads per row, two rows a
  CTA, beyond. It agrees with the plain twin to the f32 rounding of a
  d-term sum (and one bf16 step where that rounding crosses a bf16
  boundary), not bitwise.

``models.common.rms_norm`` / ``layer_norm`` dispatch here: the kernel for
a CUDA tensor when autograd records nothing for the call, the plain twin
under autograd (training) and on the CPU. There is no fallback: a build
or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_WIDTH = 8192      # d: 32 values a thread in registers, 256 threads
ROUTES = {"narrow": 1, "wide": 2}   # the C library's route codes


def _lib():
    lib = _build.load("row_norm")
    if not getattr(lib, "_typed", False):
        fn = lib.repro_row_norm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_row_norm_max_rows.argtypes = [ctypes.c_int] * 2
        lib.repro_row_norm_max_rows.restype = ctypes.c_int
        lib.repro_row_norm_plan.argtypes = [ctypes.c_int] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        lib.repro_row_norm_plan.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, *,
                   eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, *, eps: float = 1e-5
                     ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)
            + bias.to(torch.float32)).to(dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base (the kernel's vector
    loads), copied only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def plan(d: int) -> dict:
    """The kernel's route for rows of width ``d`` (a function of d
    alone): ``route`` "narrow" (one warp per row) or "wide" (``threads``
    threads per row), ``rows`` rows a CTA, ``threads``, the virtual
    threads whose order both routes walk, and ``max_rows``, the most
    rows per CTA the C entry ``repro_row_norm_ex`` takes on each route
    when one is forced (0: the route cannot run d). Builds the library;
    every number comes from it."""
    lib = _lib()
    out = [ctypes.c_int() for _ in range(3)]
    if lib.repro_row_norm_plan(d, *(ctypes.byref(v) for v in out)):
        raise ValueError(f"row norm: no plan for d={d} "
                         f"(d from 1 to {MAX_WIDTH})")
    route, rows, threads = (v.value for v in out)
    return {"route": "narrow" if route == ROUTES["narrow"] else "wide",
            "rows": rows, "threads": threads,
            "max_rows": {name: lib.repro_row_norm_max_rows(d, code)
                         for name, code in ROUTES.items()}}


def row_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None, *,
                  eps: float) -> torch.Tensor:
    """Launch ``csrc/row_norm.cu``: the RMS norm (``bias`` None) or the
    layer norm of every row of ``x`` [..., d], bf16 or f32 on the card,
    with f32 ``weight`` (and ``bias``) [d], on the route ``plan`` picks.
    Returns a new tensor of x's shape and dtype."""
    d = x.shape[-1]
    params = (weight,) if bias is None else (weight, bias)
    if not (x.is_cuda and all(p.is_cuda and p.device == x.device
                              for p in params)):
        raise ValueError("row_norm_cuda takes CUDA tensors on one device, "
                         f"got {x.device} and "
                         f"{[str(p.device) for p in params]}")
    if x.dtype not in (torch.bfloat16, torch.float32) or any(
            p.dtype != torch.float32 or p.shape != (d,) for p in params):
        raise ValueError(f"row_norm_cuda takes bf16 / f32 x [..., d] and "
                         f"f32 [d] weights, got x {x.dtype} "
                         f"{tuple(x.shape)} and "
                         f"{[(p.dtype, tuple(p.shape)) for p in params]}")
    m = x.numel() // d if d else 0
    if m < 1 or not 1 <= d <= MAX_WIDTH or m >= 2 ** 31:
        raise ValueError(f"row_norm_cuda: unsupported shape M={m}, d={d} "
                         f"(d at most {MAX_WIDTH})")
    rows = _aligned(x.reshape(m, d))
    w = _aligned(weight)
    b = None if bias is None else _aligned(bias)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.repro_row_norm(
        rows.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), m, d, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("row_norm kernel launch failed: "
                           + lib.repro_error_string(err).decode())
    _build.launches["row_norm"] += 1
    return out.reshape(x.shape)


def _use_kernel(x: torch.Tensor, *params) -> bool:
    """The kernel for a CUDA tensor unless autograd records the call."""
    return x.is_cuda and not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, *params)))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    if _use_kernel(x, weight):
        return row_norm_cuda(x, weight.to(torch.float32), eps=eps)
    return rms_norm_plain(x, weight, eps=eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-5) -> torch.Tensor:
    if _use_kernel(x, weight, bias):
        return row_norm_cuda(x, weight.to(torch.float32),
                             bias.to(torch.float32), eps=eps)
    return layer_norm_plain(x, weight, bias, eps=eps)


def bytes_moved(m: int, d: int, x_bytes: int = 2, layer: bool = False
                ) -> int:
    """Least HBM traffic of one call: x read once, y written once, the
    f32 weight (and bias) read once."""
    return 2 * m * d * x_bytes + 4 * d * (2 if layer else 1)
