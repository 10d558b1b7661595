"""The bf16 product: plain twin, CUDA kernel wrapper, autograd forms and
the one dispatcher that picks among them.

The product ``x @ w`` with bf16 operands and an f32 result, [M, K] x
[K, N] or batched [B, M, K] x [B, K, N] (the MoE's experts, flash
attention's heads), the function ``models.common.dense``,
``moe._expert_matmul`` and flash attention's score and PV products
compute.

* ``invariant_gemm_plain`` is the widened-f32 ``torch.matmul`` of the
  bf16-rounded operands, the form the port runs on the CPU.
* ``invariant_gemm_cuda`` launches ``csrc/invariant_gemm.cu``, one kernel
  per call: wgmma tiles whose K walk, and whose K split (``split_plan``:
  a count and a fold order set by (K, N) and a batch count fixed by the
  model, never by M or by how many sequences share the call), make each
  output row bitwise the same at any M, in any place of the batch. Two
  routes (``pick_route``: skinny for M <= ``SKINNY_ROWS``, the parts on
  CTAs of one cluster that fold them through distributed shared memory;
  wide above, one CTA walking every part) give the same bits. cuBLAS picks its kernel by M,
  which made a row's bits depend on the rows beside it (ROADMAP queue C
  item 2). It agrees with the twin to the f32 rounding of a K-term sum,
  not bitwise.
* ``_Bf16Product`` / ``_Bf16BatchedProduct``: the card's training form,
  cuBLAS tensor-core products with a backward (a DTensor's on the CPU
  too, with the twin's arithmetic).

``product`` is the one dispatcher: the kernel for a CUDA tensor when
autograd records nothing for the call (``use_kernel``, the row norm's
rule: every served product), the autograd form under autograd on the
card (training), the twin on the CPU. There is no fallback: a build or
launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, traced
# the kernel for a CUDA tensor unless autograd records the call (the row
# norm's rule)
from repro_torch.kernels.row_norm import (  # noqa: F401
    _use_kernel as use_kernel)

BN = 128                          # the kernel's column tile
BK = 32                           # the K split's granule
PLAN_TILE = 64                    # the columns a tile counts in the plan
SKINNY_ROWS = 64                  # the skinny route's rows (one tile)
WIDE_ROWS = 128                   # the wide route's row tile
TARGET_CTAS = 132                 # an H100's SMs
MAX_SPLITS = 16                   # the kernel's kMaxSplits (a cluster)
# the batched twin widens this many weight elements at a time (a chunk of
# experts), so a full-width MoE layer (a [160, 5120, 3072] ``w_gate_up``)
# never makes more than a ~1 GiB f32 copy of its weights per call; chunks
# of whole batch entries give the same bits
PLAIN_CHUNK_ELEMS = 1 << 28


def _lib():
    lib = _build.load("invariant_gemm")
    if not getattr(lib, "_typed", False):
        fn = lib.repro_invariant_gemm
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def split_plan(batch: int, k: int, n: int) -> tuple[int, int]:
    """(S, granules per part): the K split of every call with these (B, K,
    N), whatever M is, in granules of ``BK``. Enough parts that B x
    ceil(N / ``PLAN_TILE``) x S reach the card's SMs, at most
    ``MAX_SPLITS``, every part at least one granule and none empty: the
    kernel's first form's rule, kept so that a product keeps its bits
    wherever that rule asked for ``MAX_SPLITS`` parts or fewer. ``batch``
    is a count the model fixes (1, the experts, the heads), never the
    sequences of a call."""
    tiles = batch * -(-n // PLAN_TILE)
    kg = -(-k // BK)
    want = min(kg, MAX_SPLITS, max(1, -(-TARGET_CTAS // tiles)))
    cpg = -(-kg // want)
    return -(-kg // cpg), cpg


def pick_route(m: int) -> str:
    """The kernel's route for M rows: ``"skinny"`` (decode and verify:
    the K split's parts on the CTAs of one cluster, folded through
    distributed shared memory) up to ``SKINNY_ROWS``, ``"wide"``
    (prefill: a CTA of 128 rows walks every part into a running total)
    above. Both give the same bits; neither changes ``split_plan``."""
    return "skinny" if m <= SKINNY_ROWS else "wide"


def invariant_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 ``x @ w`` of the bf16-rounded operands, widened to f32; a
    batched w [B, K, N] is widened ``PLAIN_CHUNK_ELEMS`` at a time."""
    def widened(t):
        return t.to(torch.bfloat16).to(torch.float32)
    if w.dim() != 3:
        return torch.matmul(widened(x), widened(w))
    step = max(1, PLAIN_CHUNK_ELEMS // (w.shape[1] * w.shape[2]))
    return torch.cat([torch.matmul(widened(x[i:i + step]),
                                   widened(w[i:i + step]))
                      for i in range(0, w.shape[0], step)])


def invariant_gemm_cuda(x: torch.Tensor, w: torch.Tensor, *,
                        plan_batch: int | None = None,
                        route: str | None = None) -> torch.Tensor:
    """Launch ``csrc/invariant_gemm.cu``: bf16 x [M, K] (or [B, M, K]) and
    w [K, N] (or [B, K, N]) on the card -> f32 [M, N] (or [B, M, N]), each
    row's bits independent of M. ``plan_batch`` (default B) is the batch
    count the K split is planned for: a caller whose B grows with the
    sequences of the call (flash attention's b x heads) passes the part
    the model fixes (the heads), so a sequence's bits do not depend on
    how many share the call. ``route`` forces a route (default
    ``pick_route(M)``), to hold the two against each other."""
    return _invariant_gemm(x, w, plan_batch, route)


@traced.kernel("invariant_gemm", "(Tensor x, Tensor w, int? plan_batch, "
               "str? route) -> Tensor")
def _invariant_gemm(x, w, plan_batch, route):
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("invariant_gemm_cuda takes CUDA tensors on one "
                         f"device, got {x.device} and {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"invariant_gemm_cuda takes bf16 operands, got "
                         f"{x.dtype} and {w.dtype}")
    batched = x.dim() == 3
    if x.dim() not in (2, 3) or w.dim() != x.dim() or \
            x.shape[-1] != w.shape[-2] or (batched
                                           and x.shape[0] != w.shape[0]):
        raise ValueError(f"invariant_gemm_cuda takes [M, K] x [K, N] or "
                         f"[B, M, K] x [B, K, N], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    xb = x if batched else x[None]
    wb = w if batched else w[None]
    b, m, k = xb.shape
    n = wb.shape[2]
    wide = (route or pick_route(m)) == "wide"
    row_tiles = -(-m // (WIDE_ROWS if wide else SKINNY_ROWS))
    if min(b, m, k, n) < 1 or max(k, n) >= 2 ** 31 or m * n >= 2 ** 31 or \
            row_tiles > 65535 or b * m * max(k, n) >= 2 ** 62:
        raise ValueError(f"invariant_gemm_cuda: unsupported shape B={b}, "
                         f"M={m}, K={k}, N={n}")
    splits, cps = split_plan(b if plan_batch is None else plan_batch, k, n)
    if b * (1 if wide else splits) > 65535:
        raise ValueError(f"invariant_gemm_cuda: B={b} x {splits} parts is "
                         "past the grid's z limit")
    xb, wb = xb.contiguous(), wb.contiguous()
    aligned = int(k % 8 == 0 and n % 8 == 0 and xb.data_ptr() % 16 == 0
                  and wb.data_ptr() % 16 == 0)
    y = torch.empty((b, m, n), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.repro_invariant_gemm(
        xb.data_ptr(), wb.data_ptr(), y.data_ptr(), b, m, n, k, splits, cps,
        int(wide), aligned, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("invariant_gemm kernel launch failed: "
                           + lib.repro_error_string(err).decode())
    _build.launches["invariant_gemm"] += 1
    return y if batched else y[0]


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a @ b`` of bf16 operands, [M, K] x [K, N] or [B, M, K] x
    [B, K, N]: the tensor cores' GEMM (cuBLAS) on the card or in a trace
    of it, the twin elsewhere."""
    if traced.on_card(a):
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)
    return invariant_gemm_plain(a, b)


def _rounded_grad(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A product's f32 gradient rounded to its operand's dtype. A
    DTensor's pending partial sums are summed first, in f32, as one
    process sums the K terms before it rounds (rounding each partial to
    bf16 first moved 8-rank MoE gradients by up to 6e-3), into the
    operand's own split where it has one."""
    if type(g) is not torch.Tensor:
        from repro_torch.distributed.sharding import reduce_partial
        g = reduce_partial(g, like)
    return g.to(like.dtype)


class _Bf16Product(torch.autograd.Function):
    """The bf16 product under autograd, [M, K] x [K, N] -> f32 [M, N], on
    the card's tensor cores (``aten::mm.dtype`` has no backward), and
    for a DTensor on the CPU with the twin's arithmetic.

    The gradients are those ``jax.grad`` gives through the reference's
    ``dense``: the incoming f32 gradient is the widening of the bf16
    output's gradient (exact in bf16), dX = dY W^T and dW = X^T dY are
    bf16 products with f32 results, each rounded to its operand's dtype,
    bf16 (the casts in ``dense`` carry them on to the caller's dtypes),
    a DTensor's partial sums summed before (``_rounded_grad``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _f32_product(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(torch.bfloat16)
        if type(dy) is not torch.Tensor:
            from repro_torch.distributed.sharding import product_grad_layout
            dy = product_grad_layout(dy, x, w)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _rounded_grad(_f32_product(dy, w.t()), x)
        if ctx.needs_input_grad[1]:
            dw = _rounded_grad(_f32_product(x.t(), dy), w)
        return dx, dw


class _Bf16BatchedProduct(torch.autograd.Function):
    """The batched form, [E, C, d] x [E, d, f] -> f32 [E, C, f]
    (``aten::bmm.dtype`` has no backward either): ``_Bf16Product`` per
    batch entry, dX = dY W^T and dW = X^T dY as bf16 products with f32
    results, each rounded to its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _f32_product(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(torch.bfloat16)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _rounded_grad(_f32_product(dy, w.transpose(1, 2)), x)
        if ctx.needs_input_grad[1]:
            dw = _rounded_grad(_f32_product(x.transpose(1, 2), dy), w)
        return dx, dw


def product(x: torch.Tensor, w: torch.Tensor, *,
            plan_batch: int | None = None) -> torch.Tensor:
    """f32 ``x @ w`` of the bf16-rounded operands: x [..., K] with w
    [K, N], or x [B..., M, K] with w [B..., K, N]. On the card the kernel
    when autograd records nothing for the call (``plan_batch`` as in
    ``invariant_gemm_cuda``), else ``_Bf16Product`` /
    ``_Bf16BatchedProduct``, each on the leading dims flattened into one;
    on the CPU the twin, a DTensor's through the same autograd forms, so
    that its partial gradients are summed before they round on either
    device. A traced call (``kernels.traced``) reaches the kernel's
    operator with its dims as they are, so that x's row shards are not
    interleaved."""
    batched = w.dim() >= 3
    kernel = use_kernel(x, w)
    if not (kernel or traced.on_card(x)) and type(x) is torch.Tensor \
            and type(w) is torch.Tensor:
        return invariant_gemm_plain(x, w)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if kernel and traced.active(xb, wb):
        return invariant_gemm_cuda(xb, wb, plan_batch=plan_batch)
    if batched:
        x3 = xb.reshape(-1, *xb.shape[-2:])
        w3 = wb.reshape(-1, *wb.shape[-2:])
        y = (invariant_gemm_cuda(x3, w3, plan_batch=plan_batch) if kernel
             else _Bf16BatchedProduct.apply(x3, w3))
        return y.reshape(*x.shape[:-1], w.shape[-1])
    x2 = xb.reshape(-1, x.shape[-1])
    y = (invariant_gemm_cuda(x2, wb, plan_batch=plan_batch) if kernel
         else _Bf16Product.apply(x2, wb))
    y = y.reshape(*x.shape[:-1], w.shape[-1])
    if type(y) is not torch.Tensor and y.requires_grad:
        from repro_torch.distributed.sharding import grad_laid_as_forward
        y = grad_laid_as_forward(y)
    return y


def bytes_moved(m: int, k: int, n: int, batch: int = 1) -> int:
    """Least HBM traffic of one call: x and w read once (bf16), y written
    once (f32)."""
    return batch * (2 * m * k + 2 * k * n + 4 * m * n)


def flops(m: int, k: int, n: int, batch: int = 1) -> int:
    return 2 * batch * m * k * n
