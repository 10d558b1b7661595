"""Flash attention (online softmax): plain twin + CUDA kernel wrapper.

Port of ``repro.kernels.flash_attention``: q / k [BH, L, D], v
[BH, Lk, Dv] in f32 or bf16, f32 arithmetic, the output [BH, Lq, Dv] in
q's dtype. The semantics are the Pallas kernel's (not its test
oracle's): the causal mask is top-left, ``q_pos >= k_pos`` (it differs
from a bottom-right ``tril(k=Lk-Lq)`` when Lq != Lk), key blocks wholly
above the diagonal are skipped, ragged Lq / Lk are masked (key rows past
Lk never contribute), masked p is multiplied to 0, and the output is
``acc / max(l, 1e-30)``.

* ``flash_attention_plain`` walks the reference's (qc, kc) blocks in
  order, one online-softmax step per key block.
* ``flash_attention_cuda`` launches one of three kernels, by ``route``:
  inputs whose D and Dv are multiples of 16 up to 128 go to
  ``csrc/flash_attention_wgmma.cu`` (wgmma on the tensor cores): bf16
  with p rounded to bf16 for the P V product, f32 with every operand as
  exact bf16 planes and six plane products per product; other head dims
  to ``csrc/flash_attention.cu`` (CUDA cores, f32 products). All tile by
  their own sizes (design and bound in those files), so they agree with
  the twin at a tolerance, not bitwise.
* ``flash_attention`` dispatches on q's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_IO_TYPES = {torch.bfloat16: 0, torch.float32: 1}
_SMEM_LIMIT = 227 * 1024         # H100 dynamic shared memory per block
WGMMA_ROWS = 128                 # query rows per CTA of the tensor-core route


def tile_mask(q_start, k_start, qc: int, kc: int, *, causal: bool = False,
              q_limit=None, k_limit=None, device=None):
    """Boolean [qc, kc] validity mask of one score tile whose global
    offsets are ``q_start`` / ``k_start``; ``q_limit`` / ``k_limit`` are
    exclusive ragged bounds. None when no constraint applies."""
    q_pos = q_start + torch.arange(qc, device=device)[:, None]
    k_pos = k_start + torch.arange(kc, device=device)[None, :]
    mask = None
    if causal:
        mask = q_pos >= k_pos
    if q_limit is not None:
        lim = (q_pos < q_limit).expand(qc, kc)
        mask = lim if mask is None else mask & lim
    if k_limit is not None:
        lim = (k_pos < k_limit).expand(qc, kc)
        mask = lim if mask is None else mask & lim
    return mask


def _check(q, k, v) -> tuple[int, int, int, int, int]:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash attention takes q / k / v [BH, L, D]")
    bh, lq, d = q.shape
    _, lk, dv = v.shape
    if k.shape != (bh, lk, d) or v.shape[0] != bh or lq < 1 or lk < 1:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    return bh, lq, lk, d, dv


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          q_block: int = 256,
                          kv_block: int = 256) -> torch.Tensor:
    """The reference kernel's arithmetic in PyTorch ops, block by block."""
    bh, lq, lk, d, dv = _check(q, k, v)
    qc, kc = min(q_block, lq), min(kv_block, lk)
    scale = d ** -0.5
    out = torch.empty((bh, lq, dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, lq, qc):
        qs = q[:, q0:q0 + qc].float()
        rows = qs.shape[1]
        m = torch.full((bh, rows, 1), NEG_INF, device=q.device)
        l = torch.zeros((bh, rows, 1), device=q.device)
        acc = torch.zeros((bh, rows, dv), device=q.device)
        for k0 in range(0, lk, kc):
            if causal and k0 > q0 + qc - 1:
                break                     # this and later blocks are dead
            ks, vs = k[:, k0:k0 + kc].float(), v[:, k0:k0 + kc].float()
            s = (qs @ ks.transpose(1, 2)) * scale
            mask = tile_mask(q0, k0, rows, ks.shape[1], causal=causal,
                             device=q.device)
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            if mask is not None:
                p = p * mask
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p @ vs
            m = m_new
        out[:, q0:q0 + rows] = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        fn = lib.repro_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_flash_attention_smem.argtypes = [ctypes.c_int] * 2
        lib.repro_flash_attention_smem.restype = ctypes.c_longlong
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _wgmma_lib():
    lib = _build.load("flash_attention_wgmma")
    if not getattr(lib, "_typed", False):
        for fn in (lib.repro_flash_attention_wgmma,
                   lib.repro_flash_attention_wgmma_f32):
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        for fn in (lib.repro_flash_attention_wgmma_smem,
                   lib.repro_flash_attention_wgmma_f32_smem):
            fn.argtypes = [ctypes.c_int] * 2
            fn.restype = ctypes.c_longlong
        lib.repro_flash_attention_wgmma_f32_rows.argtypes = [ctypes.c_int]
        lib.repro_flash_attention_wgmma_f32_rows.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def route(q, k, v) -> str:
    """The kernel a CUDA call takes, by dtype and head dims alone: where D
    and Dv are multiples of 16 up to 128, the tensor cores
    (``csrc/flash_attention_wgmma.cu``): ``flash_attention_wgmma`` for
    bf16, ``flash_attention_wgmma_f32`` for f32 (exact bf16 planes); else
    ``flash_attention`` (``csrc/flash_attention.cu``, the CUDA cores, full
    f32 products). Each counts its launches under its own name in
    ``_build.launches``."""
    *_, d, dv = _check(q, k, v)
    if (q.dtype in _IO_TYPES and k.dtype == v.dtype == q.dtype
            and d % 16 == 0 and dv % 16 == 0 and d <= MAX_HEAD_DIM
            and dv <= MAX_HEAD_DIM):
        return ("flash_attention_wgmma" if q.dtype == torch.bfloat16
                else "flash_attention_wgmma_f32")
    return "flash_attention"


def flash_attention_cuda(q, k, v, *, causal: bool = True, q_block: int = 256,
                         kv_block: int = 256) -> torch.Tensor:
    """Launch the route's kernel (``route``); same contract as the plain
    twin. The kernels pick their own tiles, so ``q_block`` / ``kv_block``
    change no number beyond rounding."""
    bh, lq, lk, d, dv = _check(q, k, v)
    dev = q.device
    for t in (q, k, v):
        if not t.is_cuda or t.device != dev or not t.is_contiguous():
            raise ValueError("flash_attention_cuda takes contiguous tensors "
                             "on one CUDA device")
    if q.dtype not in _IO_TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q / k / v must all be f32 or all bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims up to {MAX_HEAD_DIM}, got D={d}, "
                         f"Dv={dv}")
    name = route(q, k, v)
    wgmma = name != "flash_attention"
    if wgmma:
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the tensor-core route reads 16-byte rows: q / "
                             "k / v must start 16-byte aligned")
        lib = _wgmma_lib()
        if name == "flash_attention_wgmma":
            rows = WGMMA_ROWS
            smem = lib.repro_flash_attention_wgmma_smem(d, dv)
        else:
            rows = lib.repro_flash_attention_wgmma_f32_rows(d)
            smem = lib.repro_flash_attention_wgmma_f32_smem(d, dv)
        if -(-lq // rows) > 65535:
            raise ValueError(f"Lq={lq} exceeds the grid's 65535 query tiles")
    else:
        if bh > 65535:
            raise ValueError(f"BH={bh} exceeds the grid's 65535")
        lib = _lib()
        smem = lib.repro_flash_attention_smem(d, dv)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"D={d}, Dv={dv} need more shared memory than "
                         f"{_SMEM_LIMIT} B")
    out = torch.empty((bh, lq, dv), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if wgmma:
        fn = (lib.repro_flash_attention_wgmma if name == "flash_attention_wgmma"
              else lib.repro_flash_attention_wgmma_f32)
        err = fn(*ptrs, bh, lq, lk, d, dv, float(d ** -0.5), int(causal),
                 stream)
    else:
        err = lib.repro_flash_attention(
            *ptrs, bh, lq, lk, d, dv, float(d ** -0.5), int(causal),
            _IO_TYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.repro_error_string(err).decode())
    _build.launches[name] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, q_block: int = 256,
                    kv_block: int = 256) -> torch.Tensor:
    """q / k / v [BH, L, D] -> [BH, Lq, Dv] in q's dtype: the plain twin
    for a CPU tensor, the kernel for a CUDA tensor. Ragged lengths need
    no padding."""
    fn = flash_attention_cuda if q.is_cuda else flash_attention_plain
    return fn(q, k, v, causal=causal, q_block=q_block, kv_block=kv_block)


def pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs one head attends: all, or q_pos >= k_pos."""
    if not causal:
        return lq * lk
    full = max(0, min(lq, lk))          # rows 0..lk-1 see q_pos + 1 keys
    return full * (full + 1) // 2 + max(0, lq - lk) * lk


def flops(bh: int, lq: int, lk: int, d: int, dv: int, causal: bool) -> int:
    """Flops the data needs: 2 D for each score and 2 Dv for each p v."""
    return bh * pairs(lq, lk, causal) * 2 * (d + dv)


def bytes_moved(q, k, v) -> int:
    """Least HBM traffic: q, k, v read once, the output written once."""
    out = q.shape[0] * q.shape[1] * v.shape[2] * q.element_size()
    return sum(t.numel() * t.element_size() for t in (q, k, v)) + out
