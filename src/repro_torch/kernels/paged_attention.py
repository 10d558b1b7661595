"""Paged-attention superkernel, GQA and MLA latent forms: plain twins +
CUDA kernel wrappers.

GQA form — port of ``repro.kernels.paged_attention.paged_attention_pallas``: W query
rows per sequence attend a block-paged K/V pool through a block table,
row ``w`` seeing keys below ``q_offsets + 1 + w``, with a Neumaier-
compensated online softmax (``l`` and ``acc`` kept as sum + carry, the
rescale applied to both). int8 / fp8 pools carry per-(token, head) f32
scales folded post-dot (``kscale``) and into p (``vscale``).

* ``paged_attention_plain`` walks the table one block at a time, as the
  reference does: dead blocks (``j * bs >= lens``) leave the state
  untouched, masked keys contribute an exact identity update. Each score
  and each output element is a row-local reduction, so the plain twin is
  bitwise width-invariant too.
* ``paged_attention_cuda`` launches ``csrc/paged_attention.cu``: a split
  kernel over fixed partitions of ``SLOTS_PER_PARTITION`` table slots and
  a merge kernel that folds the partitions in index order, through an f32
  scratch of ``scratch_floats`` (design, bound and numerics in that
  file). One call counts one ``paged_attention`` launch.

Layouts are the reference's: q [B, W, Hq, D]; pools [nb, bs, Hkv, D];
scales [nb, bs, Hkv]; table [B, mb] int32; lens, q_offsets [B] int32.
The output is [B, W, Hq, Dv] in q's dtype.

MLA latent form — port of ``paged_latent_attention_pallas``: the W * H
query rows of a sequence attend ONE latent stream, scores
``(q_lat . c_kv [* cs] + q_rope . k_rope [* rs]) * scale`` and the value
the c_kv latent itself. q_lat [B, W, H, C]; q_rope [B, W, H, R]; pools
[nb, bs, C] / [nb, bs, R]; per-token scales [nb, bs]; the output is the
f32 context latent [B, W, H, C]. ``paged_latent_attention_plain`` is the
block-by-block twin, ``paged_latent_attention_cuda`` launches
``csrc/paged_latent_attention.cu``: a split kernel on the tensor cores over
fixed partitions of table slots (q, p and f32 pools as exact bf16 planes)
and a merge kernel that folds the partitions in index order, a chunk of
partitions at a time, through an f32 scratch whose size the library
gives (one chunk's partitions: it does not grow with the context); one
call counts one ``paged_latent_attention`` launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import kahan
from repro_torch.kernels import _build
from repro_torch.quant.core import cast_f32

NEG_INF = -1e30
MAX_ROWS = 64                    # W * groups per kv head the kernel takes
SLOTS_PER_PARTITION = 4          # table slots per partition of the split
_SMEM_LIMIT = 227 * 1024         # H100 dynamic shared memory per block
_POOL_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2,
               torch.uint8: 3}
_IO_TYPES = {torch.bfloat16: 0, torch.float32: 1}


# ------------------------------------------------------------ plain twin ---

def paged_attention_plain(q, kpool, vpool, block_table, lens, q_offsets, *,
                          kscale=None, vscale=None, scale=None):
    """The superkernel's arithmetic in PyTorch ops, block by block."""
    b, w, hq, d = q.shape
    _, bs, hkv, _ = kpool.shape
    dv = vpool.shape[-1]
    mb = block_table.shape[1]
    groups = hq // hkv
    rows = w * groups
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    qg = (q.reshape(b, w, hkv, groups, d).permute(0, 2, 1, 3, 4)
          .reshape(b, hkv, rows, d).to(torch.float32))
    row_limits = (q_offsets.to(torch.int64)[:, None] + 1
                  + torch.arange(rows, device=dev)[None, :] // groups)
    m = torch.full((b, hkv, rows, 1), NEG_INF, device=dev)
    ls = torch.zeros((b, hkv, rows, 1), device=dev)
    lc = torch.zeros_like(ls)
    accs = torch.zeros((b, hkv, rows, dv), device=dev)
    accc = torch.zeros_like(accs)
    lens = lens.to(torch.int64)
    for j in range(mb):
        live = j * bs < lens                                   # [B]
        if not bool(live.any()):
            break
        blk = block_table[:, j].to(torch.int64)
        k = cast_f32(kpool[blk]).permute(0, 2, 1, 3)          # [B,Hkv,bs,D]
        vt = cast_f32(vpool[blk]).permute(0, 2, 3, 1)         # [B,Hkv,Dv,bs]
        s = (qg[:, :, :, None, :] * k[:, :, None, :, :]).sum(-1) * scale
        if kscale is not None:
            s = s * kscale[blk].permute(0, 2, 1)[:, :, None, :]
        k_pos = j * bs + torch.arange(bs, device=dev)
        mask = (k_pos[None, None, :] < row_limits[:, :, None])[:, None]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new) * mask
        corr = torch.exp(m - m_new)
        nls, nlc = kahan.neumaier_step(ls * corr, lc * corr,
                                       p.sum(dim=-1, keepdim=True))
        if vscale is not None:
            p = p * vscale[blk].permute(0, 2, 1)[:, :, None, :]
        pv = (p[:, :, :, None, :] * vt[:, :, None, :, :]).sum(-1)
        naccs, naccc = kahan.neumaier_step(accs * corr, accc * corr, pv)
        keep = live[:, None, None, None]
        m = torch.where(keep, m_new, m)
        ls = torch.where(keep, nls, ls)
        lc = torch.where(keep, nlc, lc)
        accs = torch.where(keep, naccs, accs)
        accc = torch.where(keep, naccc, accc)
    out = (accs + accc) / torch.clamp_min(ls + lc, 1e-30)
    return (out.to(q.dtype).reshape(b, hkv, w, groups, dv)
            .permute(0, 2, 1, 3, 4).reshape(b, w, hq, dv))


# ------------------------------------------------------------ CUDA kernel --

def _lib():
    lib = _build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        fn = lib.repro_paged_attention
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_paged_attention_smem.argtypes = [ctypes.c_int] * 5
        lib.repro_paged_attention_smem.restype = ctypes.c_longlong
        lib.repro_paged_attention_slots.argtypes = []
        lib.repro_paged_attention_slots.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        if lib.repro_paged_attention_slots() != SLOTS_PER_PARTITION:
            raise RuntimeError("csrc/paged_attention.cu splits the table "
                               f"into {lib.repro_paged_attention_slots()} "
                               f"slots per partition, the wrapper into "
                               f"{SLOTS_PER_PARTITION}")
        lib._typed = True
    return lib


def partitions(mb: int) -> int:
    """Partitions of a table of ``mb`` slots: partition p owns slots
    [p * S, (p + 1) * S), S = ``SLOTS_PER_PARTITION`` (S * bs tokens),
    whatever the lengths, the width or the batch."""
    return -(-mb // SLOTS_PER_PARTITION)


def scratch_floats(b: int, hkv: int, rows: int, dv: int, mb: int) -> int:
    """f32 scratch one call needs: per (sequence, kv head, partition) the
    partition's (m, l_sum, l_carry) per row and (acc_sum, acc_carry) per
    output element."""
    return b * hkv * partitions(mb) * rows * (3 + 2 * dv)


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def paged_attention_cuda(q, kpool, vpool, block_table, lens, q_offsets, *,
                         kscale=None, vscale=None, scale=None):
    """Launch ``csrc/paged_attention.cu``; same contract as the plain twin."""
    b, w, hq, d = q.shape
    nb, bs, hkv, dk = kpool.shape
    dv = vpool.shape[-1]
    mb = block_table.shape[1]
    dev = q.device
    tensors = [q, kpool, vpool, block_table, lens, q_offsets]
    quant = kscale is not None
    if quant:
        tensors += [kscale, vscale]
    for t in tensors:
        _need(t.is_cuda and t.device == dev, "all inputs on one CUDA device")
        _need(t.is_contiguous(), "inputs must be contiguous")
    _need(q.dtype in _IO_TYPES, f"q dtype {q.dtype}")
    _need(kpool.dtype in _POOL_TYPES and vpool.dtype == kpool.dtype,
          f"pool dtypes {kpool.dtype}/{vpool.dtype}")
    _need(quant == (kpool.dtype in (torch.int8, torch.uint8)),
          "int8/fp8 pools need kscale and vscale, bf16/f32 pools take none")
    _need(dk == d and vpool.shape[:3] == (nb, bs, hkv), "pool shapes")
    _need(hkv > 0 and hq % hkv == 0, "Hq must be a multiple of Hkv")
    _need(block_table.dtype == lens.dtype == q_offsets.dtype == torch.int32,
          "table, lens and q_offsets must be int32")
    _need(block_table.shape[0] == lens.shape[0] == q_offsets.shape[0] == b,
          "batch sizes disagree")
    if quant:
        _need(vscale is not None and kscale.dtype == vscale.dtype
              == torch.float32, "scales must be f32")
        _need(kscale.shape == vscale.shape == (nb, bs, hkv), "scale shapes")
    rows = w * (hq // hkv)
    lib = _lib()
    smem = lib.repro_paged_attention_smem(rows, d, dv, bs,
                                          _POOL_TYPES[kpool.dtype])
    if rows > MAX_ROWS or smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention_cuda supports W * groups <= "
                         f"{MAX_ROWS} rows within {_SMEM_LIMIT} B of shared "
                         f"memory; got {rows} rows, {smem} B")
    out = torch.empty((b, w, hq, dv), dtype=q.dtype, device=dev)
    part = torch.empty(scratch_floats(b, hkv, rows, dv, mb),
                       dtype=torch.float32, device=dev)
    scale = d ** -0.5 if scale is None else float(scale)
    err = lib.repro_paged_attention(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
        kscale.data_ptr() if quant else None,
        vscale.data_ptr() if quant else None,
        block_table.data_ptr(), lens.data_ptr(), q_offsets.data_ptr(),
        out.data_ptr(), part.data_ptr(), b, w, hq, hkv, d, dv, bs, mb, scale,
        _POOL_TYPES[kpool.dtype], _IO_TYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.repro_error_string(err).decode())
    _build.launches["paged_attention"] += 1
    return out


def _live_blocks(block_table, lens, bs: int) -> int:
    mb = block_table.shape[1]
    return int(torch.clamp(-(-lens.to(torch.int64) // bs), max=mb).sum())


def bytes_moved(q, kpool, vpool, block_table, lens, *, kscale=None) -> int:
    """Least HBM traffic of one call: q and the output once, plus every
    live block's K/V payload (and scales) for its kv heads once — what
    the walk must read for these lengths."""
    per_block = (kpool[0].numel() * kpool.element_size()
                 + vpool[0].numel() * vpool.element_size())
    if kscale is not None:
        per_block += 2 * kscale[0].numel() * 4
    b, w, hq, _ = q.shape
    out = b * w * hq * vpool.shape[-1] * q.element_size()
    return (q.numel() * q.element_size() + out
            + _live_blocks(block_table, lens, kpool.shape[1]) * per_block
            + block_table.numel() * 4 + 2 * b * 4)


# ------------------------------------------- latent (MLA) form: plain twin --

def paged_latent_attention_plain(q_lat, q_rope, ck_pool, kr_pool,
                                 block_table, lens, q_offsets, *,
                                 ck_scale=None, kr_scale=None, scale: float):
    """The latent superkernel's arithmetic in PyTorch ops, block by block:
    every query row against the one latent stream, s = (q_lat . c_kv
    [* cs] + q_rope . k_rope [* rs]) * scale, value = c_kv (p scaled by
    cs for quantized pools, the normaliser summing the unscaled p).
    Returns the context latents [B, W, H, C] in f32."""
    b, w, h, c = q_lat.shape
    r = q_rope.shape[-1]
    bs = ck_pool.shape[1]
    mb = block_table.shape[1]
    rows = w * h
    dev = q_lat.device
    ql = q_lat.reshape(b, rows, c).to(torch.float32)
    qr = q_rope.reshape(b, rows, r).to(torch.float32)
    row_limits = (q_offsets.to(torch.int64)[:, None] + 1
                  + torch.arange(rows, device=dev)[None, :] // h)
    m = torch.full((b, rows, 1), NEG_INF, device=dev)
    ls = torch.zeros((b, rows, 1), device=dev)
    lc = torch.zeros_like(ls)
    accs = torch.zeros((b, rows, c), device=dev)
    accc = torch.zeros_like(accs)
    lens = lens.to(torch.int64)
    for j in range(mb):
        live = j * bs < lens                                   # [B]
        if not bool(live.any()):
            break
        blk = block_table[:, j].to(torch.int64)
        ck = cast_f32(ck_pool[blk])                            # [B, bs, C]
        kr = cast_f32(kr_pool[blk])                            # [B, bs, R]
        s_lat = (ql[:, :, None, :] * ck[:, None, :, :]).sum(-1)
        s_rope = (qr[:, :, None, :] * kr[:, None, :, :]).sum(-1)
        if ck_scale is not None:
            cs = ck_scale[blk][:, None, :]                     # [B, 1, bs]
            s = (s_lat * cs + s_rope * kr_scale[blk][:, None, :]) * scale
        else:
            s = (s_lat + s_rope) * scale
        k_pos = j * bs + torch.arange(bs, device=dev)
        mask = k_pos[None, None, :] < row_limits[:, :, None]   # [B, rows, bs]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new) * mask
        corr = torch.exp(m - m_new)
        nls, nlc = kahan.neumaier_step(ls * corr, lc * corr,
                                       p.sum(dim=-1, keepdim=True))
        if ck_scale is not None:
            p = p * cs
        pv = (p[:, :, None, :] * ck.transpose(1, 2)[:, None]).sum(-1)
        naccs, naccc = kahan.neumaier_step(accs * corr, accc * corr, pv)
        keep = live[:, None, None]
        m = torch.where(keep, m_new, m)
        ls = torch.where(keep, nls, ls)
        lc = torch.where(keep, nlc, lc)
        accs = torch.where(keep, naccs, accs)
        accc = torch.where(keep, naccc, accc)
    out = (accs + accc) / torch.clamp_min(ls + lc, 1e-30)
    return out.reshape(b, w, h, c)


# ------------------------------------------- latent (MLA) form: CUDA kernel -

def _latent_lib():
    lib = _build.load("paged_latent_attention")
    if not getattr(lib, "_typed", False):
        fn = lib.repro_paged_latent_attention
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_paged_latent_attention_smem.argtypes = [ctypes.c_int] * 4
        lib.repro_paged_latent_attention_smem.restype = ctypes.c_longlong
        lib.repro_paged_latent_attention_scratch.argtypes = [ctypes.c_int] * 4
        lib.repro_paged_latent_attention_scratch.restype = ctypes.c_longlong
        for name in ("slots", "chunk"):
            fn = getattr(lib, f"repro_paged_latent_attention_{name}")
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def latent_scratch_floats(b: int, rows: int, c: int, mb: int) -> int:
    """f32 scratch of one latent call, from the library: per sequence the
    (m, l_sum, l_carry) per row and (acc_sum, acc_carry) per output element
    of one chunk's partitions, and past one chunk the state of the chunks
    before."""
    return _latent_lib().repro_paged_latent_attention_scratch(b, rows, c, mb)


def paged_latent_attention_cuda(q_lat, q_rope, ck_pool, kr_pool, block_table,
                                lens, q_offsets, *, ck_scale=None,
                                kr_scale=None, scale: float):
    """Launch ``csrc/paged_latent_attention.cu``; same contract as the
    plain twin."""
    b, w, h, c = q_lat.shape
    nb, bs, ck_c = ck_pool.shape
    r = q_rope.shape[-1]
    mb = block_table.shape[1]
    dev = q_lat.device
    tensors = [q_lat, q_rope, ck_pool, kr_pool, block_table, lens, q_offsets]
    quant = ck_scale is not None
    if quant:
        tensors += [ck_scale, kr_scale]
    for t in tensors:
        _need(t is not None and t.is_cuda and t.device == dev,
              "all inputs on one CUDA device")
        _need(t.is_contiguous(), "inputs must be contiguous")
    _need(q_lat.dtype in _IO_TYPES and q_rope.dtype in _IO_TYPES,
          f"query dtypes {q_lat.dtype}/{q_rope.dtype}")
    _need(q_rope.shape[:3] == (b, w, h), "q_rope must be [B, W, H, R]")
    _need(ck_pool.dtype in _POOL_TYPES and kr_pool.dtype == ck_pool.dtype,
          f"pool dtypes {ck_pool.dtype}/{kr_pool.dtype}")
    _need(quant == (ck_pool.dtype in (torch.int8, torch.uint8)),
          "int8/fp8 pools need ck_scale and kr_scale, bf16/f32 pools "
          "take none")
    _need(ck_c == c and kr_pool.shape == (nb, bs, r), "pool shapes")
    _need(block_table.dtype == lens.dtype == q_offsets.dtype == torch.int32,
          "table, lens and q_offsets must be int32")
    _need(block_table.shape[0] == lens.shape[0] == q_offsets.shape[0] == b,
          "batch sizes disagree")
    if quant:
        _need(ck_scale.dtype == kr_scale.dtype == torch.float32,
              "scales must be f32")
        _need(ck_scale.shape == kr_scale.shape == (nb, bs), "scale shapes")
    _need(all(t.data_ptr() % 16 == 0 for t in (q_lat, q_rope, ck_pool,
                                               kr_pool)),
          "queries and pools must start 16-byte aligned")
    _need(w * h <= 65535, f"W * H = {w * h} rows exceed the grid's 65535")
    lib = _latent_lib()
    smem = lib.repro_paged_latent_attention_smem(
        c, r, _POOL_TYPES[ck_pool.dtype], bs)
    _need(smem > 0, f"the kernel takes C and R multiples of 8 up to 512 / "
          f"64 and a block whose tokens, padded to 16, fit the keys it holds "
          f"at once (64 for a one-plane pool, 16 for f32); got C={c}, R={r}, "
          f"bs={bs}, a {ck_pool.dtype} pool")
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_latent_attention_cuda needs {smem} B of "
                         f"shared memory for C={c}, R={r}; the limit is "
                         f"{_SMEM_LIMIT} B")
    out = torch.empty((b, w, h, c), dtype=torch.float32, device=dev)
    part = torch.empty(latent_scratch_floats(b, w * h, c, mb),
                       dtype=torch.float32, device=dev)
    err = lib.repro_paged_latent_attention(
        q_lat.data_ptr(), q_rope.data_ptr(), ck_pool.data_ptr(),
        kr_pool.data_ptr(), ck_scale.data_ptr() if quant else None,
        kr_scale.data_ptr() if quant else None, block_table.data_ptr(),
        lens.data_ptr(), q_offsets.data_ptr(), out.data_ptr(),
        part.data_ptr(), b, w, h, c, r, bs, mb, float(scale),
        _POOL_TYPES[ck_pool.dtype], _IO_TYPES[q_lat.dtype],
        _IO_TYPES[q_rope.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("paged_latent_attention kernel launch failed: "
                           + lib.repro_error_string(err).decode())
    _build.launches["paged_latent_attention"] += 1
    return out


def latent_bytes_moved(q_lat, q_rope, ck_pool, kr_pool, block_table, lens,
                       *, ck_scale=None) -> int:
    """Least HBM traffic of one latent call: the queries and the f32
    output once, plus every live block's c_kv and k_rope payload (and
    scales) once — all query rows share the one latent stream."""
    per_block = (ck_pool[0].numel() * ck_pool.element_size()
                 + kr_pool[0].numel() * kr_pool.element_size())
    if ck_scale is not None:
        per_block += 2 * ck_scale[0].numel() * 4
    b = q_lat.shape[0]
    return (q_lat.numel() * q_lat.element_size()
            + q_rope.numel() * q_rope.element_size() + q_lat.numel() * 4
            + _live_blocks(block_table, lens, ck_pool.shape[1]) * per_block
            + block_table.numel() * 4 + 2 * b * 4)


def latent_flops(q_lat, q_rope, q_offsets) -> int:
    """Flops the data needs: each query row against each key it sees
    (row w of a sequence sees q_offsets + 1 + w keys), 2 (C + R) for the
    score and 2 C for the value."""
    b, w, h, c = q_lat.shape
    r = q_rope.shape[-1]
    keys = int((q_offsets.to(torch.int64) + 1).sum()) * w \
        + b * w * (w - 1) // 2
    return keys * h * (2 * (c + r) + 2 * c)


def latent_tensor_flops(q_lat, q_rope, ck_pool, q_offsets) -> int:
    """Tensor-core flops the split kernel's products need for the data:
    each row against each key it sees, 2 C per bf16 pass of the latent
    score and of P V and 2 R per pass of the rope score. Passes are the
    plane products a query (or p, f32) makes with the pool: 1 for bf16
    against a one-plane pool (bf16, int8, fp8), 3 for f32 against one, 6
    for f32 against an f32 pool."""
    def passes(a_dtype):
        pa_, pb_ = (3 if dt == torch.float32 else 1
                    for dt in (a_dtype, ck_pool.dtype))
        return 6 if pa_ == pb_ == 3 else pa_ * pb_
    b, w, h, c = q_lat.shape
    r = q_rope.shape[-1]
    keys = int((q_offsets.to(torch.int64) + 1).sum()) * w \
        + b * w * (w - 1) // 2
    return keys * h * (2 * c * (passes(q_lat.dtype) + passes(torch.float32))
                       + 2 * r * passes(q_rope.dtype))
