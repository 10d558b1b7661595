"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device  — the card's name and ``nvidia-smi`` name / power limit;
2. build   — compiles ``src/repro_torch/csrc/*.cu`` (one nvcc each, in
             parallel) into ``build/kernels``;
3. parity  — each CUDA kernel against its plain PyTorch twin on the card
             at main-path shapes, with the tolerance and its reason (the
             GQA and the MLA latent attention kernels, the reduction);
4. times   — device time of each kernel (profiler, L2 flushed before
             each launch), CUDA-event medians of its plain twin and a
             library yardstick, beside the least time the card could
             take (HBM 3.35 TB/s, f32 CUDA-core 67 TFLOP/s; H100 SXM
             data sheet);
5. small   — reduced qwen1.5 and reduced deepseek-v2 served on the card
             and on the CPU (plain twins) from the same weights: logits
             agree;
6. serve   — two main paths behind ``DecodeEngine``, each with its launch
             counters zeroed just before and read just after: full-width
             qwen1.5-0.5b (24 layers) and full-width deepseek-v2-236b cut
             to 3 layers (1 dense + 2 MoE; MLA latent pools), random
             seeded weights, 8 slots, 16 requests of 64-512 prompt tokens,
             32 new tokens each; the counters must match the decode-step
             count.

The last two lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``. Imports nothing of ``jax`` or of the
reference package ``repro``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
F32_FLOPS_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
SEED = 0


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) for the work and what bounds it."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def time_ms(fn, flush, reps: int = 25) -> float:
    """Median CUDA-event time of ``fn``. Before each launch a 256 MB
    memset flushes the L2 (the decode path finds KV pools and logits
    cold) and keeps the card busy while the host enqueues ``fn``, so no
    host-side gap is timed."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _device_us(ev) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, attr):
            return float(getattr(ev, attr))
    return 0.0


def _device_kernels(prof):
    """The profiler's per-kernel averages (device-side events only)."""
    from torch.autograd import DeviceType
    return [ev for ev in prof.key_averages()
            if getattr(ev, "device_type", None) == DeviceType.CUDA]


def kernel_ms(fn, flush, names, reps: int = 20):
    """Mean device time (ms) per call of the CUDA kernels whose names
    contain one of ``names``, from ``torch.profiler``; None if the
    profiler saw no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(ev) for ev in _device_kernels(prof)
                if any(n in ev.key for n in names))
    return total / reps / 1e3 if total > 0 else None


# ------------------------------------------------------------ fixtures ----

def make_pools(g, dev, nb, bs, hkv, d, fmt_name):
    """Random K/V pools (payload dtype of ``fmt_name``) + scales or None."""
    import torch
    from repro_torch.quant import core as qcore
    k = torch.randn((nb, bs, hkv, d), generator=g, device=dev)
    v = torch.randn((nb, bs, hkv, d), generator=g, device=dev)
    fmt = qcore.get_format(fmt_name)
    if fmt is None:
        return k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    qk, sk = qcore.quantize_lastdim(k, fmt)
    qv, sv = qcore.quantize_lastdim(v, fmt)
    return qk, qv, sk.contiguous(), sv.contiguous()


def attention_case(dev, *, b=8, hq=16, hkv=16, d=64, bs=16, mb=32, w=1,
                   fmt="bf16", seed=1, lens=None):
    """Main-path decode inputs: ragged lengths, permuted block table."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = 1 + b * mb
    kp, vp, ks, vs = make_pools(g, dev, nb, bs, hkv, d, fmt)
    perm = 1 + torch.randperm(nb - 1, generator=g, device=dev)
    table = perm.reshape(b, mb).to(torch.int32)
    if lens is None:
        cap = mb * bs
        lens = [cap, w, 17, cap // 2 + 3, cap - 1, cap // 4, 64, 129][:b]
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((b, w, hq, d), generator=g, device=dev).to(torch.bfloat16)
    return dict(q=q, kpool=kp, vpool=vp, block_table=table, lens=lens,
                q_offsets=lens - w, kscale=ks, vscale=vs)


def latent_case(dev, *, b=8, h=128, c=512, r=64, bs=16, mb=32, w=1,
                fmt="bf16", seed=4, lens=None):
    """Latent (MLA) decode inputs at full width: ragged lengths, permuted
    block table; q_lat f32 (the absorbed query), q_rope bf16."""
    import torch
    from repro_torch.quant import core as qcore
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = 1 + b * mb
    ck = torch.randn((nb, bs, c), generator=g, device=dev)
    kr = torch.randn((nb, bs, r), generator=g, device=dev)
    qf = qcore.get_format(fmt)
    if qf is None:
        ck, kr, cs, rs = ck.to(torch.bfloat16), kr.to(torch.bfloat16), None, \
            None
    else:
        (ck, cs), (kr, rs) = (qcore.quantize_lastdim(x, qf) for x in (ck, kr))
        cs, rs = cs.contiguous(), rs.contiguous()
    perm = 1 + torch.randperm(nb - 1, generator=g, device=dev)
    table = perm.reshape(b, mb).to(torch.int32)
    if lens is None:
        cap = mb * bs
        lens = [cap, w, 17, cap // 2 + 3, cap - 1, cap // 4, 64, 129][:b]
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q_lat = torch.randn((b, w, h, c), generator=g, device=dev)
    q_rope = torch.randn((b, w, h, r), generator=g,
                         device=dev).to(torch.bfloat16)
    return dict(q_lat=q_lat, q_rope=q_rope, ck_pool=ck, kr_pool=kr,
                block_table=table, lens=lens, q_offsets=lens - w,
                ck_scale=cs, kr_scale=rs, scale=(128 + r) ** -0.5)


def _latent_args(x):
    return ((x["q_lat"], x["q_rope"], x["ck_pool"], x["kr_pool"],
             x["block_table"], x["lens"], x["q_offsets"]),
            dict(ck_scale=x["ck_scale"], kr_scale=x["kr_scale"],
                 scale=x["scale"]))


def latent_oracle(x):
    """Dequantize first, then an ordinary masked softmax, in f64."""
    import torch
    from repro_torch.models import paged
    from repro_torch.quant import core as qcore

    def rows(pool, scale):
        v = qcore.cast_f32(paged.gather_blocks(pool, x["block_table"]))
        if scale is not None:
            v = v * paged.gather_blocks(scale, x["block_table"])[..., None]
        return v.double()
    ck, kr = rows(x["ck_pool"], x["ck_scale"]), rows(x["kr_pool"],
                                                     x["kr_scale"])
    s = (torch.einsum("bwhc,bsc->bwhs", x["q_lat"].double(), ck)
         + torch.einsum("bwhr,bsr->bwhs", x["q_rope"].double(), kr)) \
        * x["scale"]
    w = x["q_lat"].shape[1]
    lim = x["q_offsets"].long()[:, None] + torch.arange(w, device=ck.device)
    kpos = torch.arange(ck.shape[1], device=ck.device)
    s = torch.where(kpos[None, None, None, :] <= lim[:, :, None, None], s,
                    -torch.inf)
    return torch.einsum("bwhs,bsc->bwhc", torch.softmax(s, -1), ck)


# ------------------------------------------------------------ phases ------

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    log(line)
    return name, line


def phase_build():
    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"[build] {', '.join(_build.SOURCES)} -> {_build.build_dir()} "
        f"in {secs:.1f} s")
    for name, out in _build.BUILD_LOG.items():
        for ln in out.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower():
                log(f"[build] {name}: {ln.strip()}")


def phase_attention_parity(dev) -> float:
    import torch
    from repro_torch.kernels import paged_attention as pa
    worst = 0.0
    cases = [dict(fmt=f, w=w) for f in ("bf16", "int8", "fp8")
             for w in (1, 5)] + [dict(fmt="bf16", w=5, hkv=4)]
    for c in cases:
        x = attention_case(dev, **c)
        args = (x["q"], x["kpool"], x["vpool"], x["block_table"], x["lens"],
                x["q_offsets"])
        kw = dict(kscale=x["kscale"], vscale=x["vscale"])
        got = pa.paged_attention_cuda(*args, **kw)
        want = pa.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        # both round one f32 result to bf16; the f32 results differ only
        # in the summation order of the scores and PV products (the
        # kernel's sequential FMA chain vs torch's reductions), so they
        # may straddle a bf16 rounding boundary: 2 bf16 ulps of the value
        tol = 2.0 ** -7 * want.float().abs() + 1e-6
        bad = int((err > tol).sum())
        worst = max(worst, float(err.max()))
        # width invariance, bitwise: row j of the width-W call equals the
        # width-1 call at q_offsets + j
        wid = c["w"]
        inv = all(torch.equal(got[:, j], pa.paged_attention_cuda(
            x["q"][:, j:j + 1].contiguous(), x["kpool"], x["vpool"],
            x["block_table"], (x["q_offsets"] + j + 1).contiguous(),
            (x["q_offsets"] + j).contiguous(), **kw)[:, 0])
            for j in range(wid))
        log(f"[parity] paged_attention {c}: max|kernel-plain| "
            f"{float(err.max()):.3g} (tol 2 bf16 ulps: f32 summation order "
            f"before one bf16 rounding), {bad} over tol; width invariance "
            f"bitwise: {inv}")
        if bad or not inv or not torch.isfinite(got.float()).all():
            fail(f"paged_attention parity {c}")
    return worst


def phase_latent_parity(dev) -> float:
    """The MLA latent kernel at the deepseek serve phase's shapes (B=8,
    H=128, C=512, R=64, bs=16, 64-block tables): bf16 / int8 / fp8 pools
    x W in {1, 5}, permuted tables and ragged tails, against its plain
    twin and the dequant-first oracle; width invariance bitwise on the
    card."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    worst = 0.0
    for fmt in ("bf16", "int8", "fp8"):
        for w in (1, 5):
            x = latent_case(dev, fmt=fmt, w=w, mb=64)
            args, kw = _latent_args(x)
            got = pa.paged_latent_attention_cuda(*args, **kw)
            want = pa.paged_latent_attention_plain(*args, **kw)
            oracle = latent_oracle(x)
            torch.cuda.synchronize()
            # f32 outputs of the same operations in another summation
            # order (576-term score dots, 16-term p.v sums per block):
            # the reference's own latent-kernel tolerance, 2e-4 abs + rel
            # (tests/test_superkernel.py), for the twin and the oracle
            err = (got - want).abs()
            err_o = (got.double() - oracle).abs()
            bad = int((err > 2e-4 + 2e-4 * want.abs()).sum())
            bad_o = int((err_o > 2e-4 + 2e-4 * oracle.abs()).sum())
            worst = max(worst, float(err.max()))
            inv = all(torch.equal(got[:, j], pa.paged_latent_attention_cuda(
                x["q_lat"][:, j:j + 1].contiguous(),
                x["q_rope"][:, j:j + 1].contiguous(), x["ck_pool"],
                x["kr_pool"], x["block_table"],
                (x["q_offsets"] + j + 1).contiguous(),
                (x["q_offsets"] + j).contiguous(), **kw)[:, 0])
                for j in range(w))
            log(f"[parity] paged_latent_attention fmt={fmt} W={w}: "
                f"max|kernel-plain| {float(err.max()):.3g}, "
                f"max|kernel-oracle| {float(err_o.max()):.3g} (tol 2e-4 abs "
                f"+ 2e-4 rel: f32 summation order), {bad} + {bad_o} over "
                f"tol; width invariance bitwise: {inv}")
            if bad or bad_o or not inv or not torch.isfinite(got).all():
                fail(f"paged_latent_attention parity fmt={fmt} W={w}")
    return worst


# the (rows, vocab) shapes the two served paths hand the reduction: an
# 8-slot decode step and a request's first token, at qwen1.5's and
# deepseek-v2's vocab widths. The split geometry follows N: 151936 gives
# 38 splits of 4000 with a ragged last one, 102400 gives 25 of 4096 and
# no tail.
REDUCE_SHAPES = ((8, 151936), (1, 151936), (8, 102400), (1, 102400))


def phase_reduce_parity(dev) -> float:
    import torch
    from repro_torch.kernels import engine
    eps = 2.0 ** -24
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for rows, n in REDUCE_SHAPES:
        worst = max(worst, reduce_rows_parity(dev, g, rows, n),
                    ill_conditioned_reduce(dev, g, rows, n))
    # the flat form: one compensated dot of 2^24 pairs against fp64
    n = 1 << 24
    a = torch.randn(n, generator=g, device=dev)
    b = torch.randn(n, generator=g, device=dev)
    (dot,) = engine.fused_reduce_flat((a, b), outputs=("dot",))
    exact = float((a.double() * b.double()).sum())
    terms = float((a.double() * b.double()).abs().sum())
    tol = 2 * eps * 2 * abs(exact) + 8 * eps ** 2 * terms
    ok = abs(float(dot) - exact) <= tol
    log(f"[parity] fused_reduce_flat dot n=2^24: |kernel-fp64| "
        f"{abs(float(dot) - exact):.3g} (tol 2 ulp + 8 eps^2 sum|xy| = "
        f"{tol:.3g}): {ok}")
    if not ok:
        fail("fused_reduce_flat dot")
    return worst


def reduce_rows_parity(dev, g, rows: int, n: int) -> float:
    """The one-operand forms ``_logit_stats`` runs, (max, sum, sumsq) and
    (sum,), plus a naive (sum, max), on [rows, n] rows of N(1, 16)."""
    import torch
    from repro_torch.kernels import engine
    eps = 2.0 ** -24
    x = (torch.randn((rows, n), generator=g, device=dev) * 4.0 + 1.0)
    x64 = x.double()
    worst = 0.0
    cases = [(("max", "sum", "sumsq"), True), (("sum",), True),
             (("sum", "max"), False)]
    for outs, comp in cases:
        got = engine.fused_reduce_rows_cuda((x,), outputs=outs,
                                            compensated=comp)
        plain = engine.fused_reduce_rows_plain((x,), outputs=outs,
                                               compensated=comp)
        torch.cuda.synchronize()
        for o, k, p in zip(outs, got, plain):
            if o == "max":
                ok = torch.equal(k, p) and torch.equal(k, x.amax(dim=1))
                log(f"[parity] fused_reduce [{rows},{n}] {o}: exact {ok}")
                if not ok:
                    fail(f"fused_reduce [{rows},{n}] max")
                continue
            terms = x64.abs() if o == "sum" else x64 * x64
            exact = (x64 if o == "sum" else x64 * x64).sum(dim=1)
            if comp:
                # both compensated: within 2 ulp of the exact sum plus the
                # O(eps^2 sum|x|) floor of the compensated fold
                tol = 2 * eps * 2 * exact.abs() + 8 * eps ** 2 * terms.sum(1)
                why = "2 ulp + 8 eps^2 sum|x| (compensated)"
            else:
                # naive f32 sums: error <= depth * eps * sum|x|, depth =
                # sequential adds per thread + the tree levels
                nsplit, seg = engine.splits(rows, n)
                depth = seg / 256 + 8 + nsplit.bit_length() + 8
                tol = depth * eps * terms.sum(1)
                why = f"{depth:.0f} eps sum|x| (naive: summation depth)"
            ek = (k.double() - exact).abs()
            ep = (p.double() - exact).abs()
            worst = max(worst, float((k.double() - p.double()).abs().max()))
            ok = bool((ek <= tol).all() and (ep <= tol).all())
            log(f"[parity] fused_reduce [{rows},{n}] {o} compensated={comp}: "
                f"max|kernel-exact| {float(ek.max()):.3g}, "
                f"max|plain-exact| {float(ep.max()):.3g}, tol {why} "
                f"(max {float(tol.max()):.3g}): {ok}")
            if not ok:
                fail(f"fused_reduce [{rows},{n}] {o} compensated={comp}")
    return worst


def ill_conditioned_reduce(dev, g, rows: int, n: int) -> float:
    """[rows, n] rows of +-a pairs (|a| ~ 1e6) that cancel exactly plus
    n/3 unit normals, shuffled: sum|x| ~ 5e10-8e10 against sums of a few
    hundred. A naive f32 sum loses the small terms under the big partial
    sums (errors of order 10-100); compensation keeps them. The
    compensated kernel must meet the compensated bound and the naive one
    must miss it by 10x, or the check could not tell a kernel that lost
    its carry from one that kept it. Two operands, (sum, dot) with a row
    of ones. Exact sums: ``math.fsum``."""
    import math
    import torch
    from repro_torch.kernels import engine
    eps = 2.0 ** -24
    third = n // 3
    a = torch.randn((rows, third), generator=g, device=dev) * 1e6
    small = torch.randn((rows, n - 2 * third), generator=g, device=dev)
    x = torch.cat([a, -a, small], dim=1)
    perm = torch.argsort(torch.rand((rows, n), generator=g, device=dev),
                         dim=1)
    x = torch.gather(x, 1, perm).contiguous()
    ones = torch.ones_like(x)          # dot with ones: exact products
    x64 = x.double().cpu()
    exact = torch.tensor([math.fsum(r) for r in x64.tolist()],
                         dtype=torch.float64)
    tol = 2 * eps * 2 * exact.abs() + 8 * eps ** 2 * x64.abs().sum(1)
    worst = 0.0
    for comp in (True, False):
        outs = ("sum", "dot")
        got = engine.fused_reduce_rows_cuda((x, ones), outputs=outs,
                                            compensated=comp)
        plain = engine.fused_reduce_rows_plain((x, ones), outputs=outs,
                                               compensated=comp)
        for o, k, p in zip(outs, got, plain):
            ek = (k.double().cpu() - exact).abs()
            ep = (p.double().cpu() - exact).abs()
            if comp:
                worst = max(worst, float((k - p).abs().max()))
                ok = bool((ek <= tol).all() and (ep <= tol).all())
                what = "both within"
            else:
                ok = bool((ek > 10 * tol).all() and (ep > 10 * tol).all())
                what = "both miss by 10x"
            log(f"[parity] fused_reduce [{rows},{n}] ill-conditioned {o} "
                f"compensated={comp}: |kernel-exact| {float(ek.min()):.3g}-"
                f"{float(ek.max()):.3g}, |plain-exact| {float(ep.min()):.3g}-"
                f"{float(ep.max()):.3g}, compensated bound 2 ulp + 8 eps^2 "
                f"sum|x| (max {float(tol.max()):.3g}), {what}: {ok}")
            if not ok:
                fail(f"fused_reduce [{rows},{n}] ill-conditioned {o} "
                     f"compensated={comp}")
    return worst


def phase_times(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import engine
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import paged
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    out = {}
    # paged attention at the serve phase's decode shapes (B = 8 slots,
    # 64-block tables, ragged contexts up to 544 tokens)
    x = attention_case(dev, mb=64,
                       lens=[544, 65, 300, 400, 97, 512, 130, 256])
    args = (x["q"], x["kpool"], x["vpool"], x["block_table"], x["lens"],
            x["q_offsets"])
    ev_ms = time_ms(lambda: pa.paged_attention_cuda(*args), flush)
    prof_ms = kernel_ms(lambda: pa.paged_attention_cuda(*args), flush,
                        ("paged_attention_kernel",))
    ms = ev_ms if prof_ms is None else prof_ms
    plain_ms = time_ms(lambda: pa.paged_attention_plain(*args), flush,
                       reps=5)
    kg = paged.gather_blocks(x["kpool"], x["block_table"]).transpose(1, 2)
    vg = paged.gather_blocks(x["vpool"], x["block_table"]).transpose(1, 2)
    kpos = torch.arange(kg.shape[2], device=dev)
    mask = (kpos[None, :] < x["lens"][:, None])[:, None, None, :]
    qs = x["q"].transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask), flush)
    nbytes = pa.bytes_moved(x["q"], x["kpool"], x["vpool"],
                            x["block_table"], x["lens"])
    live_tok = int(x["lens"].sum())
    flops = 4 * live_tok * x["q"].shape[2] * x["q"].shape[3]
    b_ms, b_by = bound(nbytes, flops)
    out["paged_attention"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms)
    log(f"[times] paged_attention B=8 W=1 Hq=Hkv=16 D=64 bs=16 "
        f"tokens={live_tok}: kernel {ms:.4f} ms (profiler device time "
        f"{prof_ms}, event median {ev_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"SDPA on gathered rows {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes} B, {flops} flop)")
    # fused reduce at the decode step's first call: [8, 151936] f32,
    # (max, sum, sumsq)
    g = torch.Generator(device=dev).manual_seed(3)
    lg = torch.randn((8, 151936), generator=g, device=dev)
    outs = ("max", "sum", "sumsq")
    ev_ms = time_ms(lambda: engine.fused_reduce_rows_cuda((lg,),
                                                          outputs=outs),
                    flush)
    prof_ms = kernel_ms(lambda: engine.fused_reduce_rows_cuda(
        (lg,), outputs=outs), flush, ("reduce_pass1", "reduce_pass2"))
    ms = ev_ms if prof_ms is None else prof_ms
    plain_ms = time_ms(lambda: engine.fused_reduce_rows_plain(
        (lg,), outputs=outs), flush, reps=5)
    nbytes = engine.bytes_moved(8, 151936, 1, len(outs))
    flops = 8 * 151936 * (6 + 1 + 6 + 1)
    b_ms, b_by = bound(nbytes, flops)
    out["fused_reduce"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
    log(f"[times] fused_reduce [8,151936] (max,sum,sumsq): kernel "
        f"{ms:.4f} ms (profiler device time, both passes: {prof_ms}, "
        f"event median {ev_ms:.4f}), plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes} B); no single PyTorch call computes the "
        f"compensated fused statistics")
    # the flat form (fused_reduce_flat): one compensated dot of 2^24 f32
    # pairs, the parity phase's shape; torch.dot is the same function,
    # uncompensated
    n = 1 << 24
    a = torch.randn(n, generator=g, device=dev)
    b = torch.randn(n, generator=g, device=dev)
    flat = lambda: engine.fused_reduce_flat((a, b), outputs=("dot",))  # noqa
    ev_ms = time_ms(flat, flush)
    prof_ms = kernel_ms(flat, flush, ("reduce_pass1", "reduce_pass2"))
    ms = ev_ms if prof_ms is None else prof_ms
    plain_ms = time_ms(lambda: engine.fused_reduce_flat_plain(
        (a, b), outputs=("dot",)), flush, reps=3)
    lib_ms = time_ms(lambda: torch.dot(a, b), flush)
    nbytes = engine.bytes_moved(1, n, 2, 1)
    flops = n * 8            # product, TwoSum (6), carry add
    b_ms, b_by = bound(nbytes, flops)
    out["fused_reduce_flat"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=lib_ms)
    log(f"[times] fused_reduce_flat dot n=2^24: kernel {ms:.4f} ms "
        f"(profiler device time, both passes: {prof_ms}, event median "
        f"{ev_ms:.4f}), plain {plain_ms:.4f} ms, torch.dot {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop)")
    # the latent (MLA) kernel at the deepseek serve phase's decode shape:
    # B = 8 slots, W = 1, H = 128, C = 512, R = 64, bs = 16, 64-block
    # tables, 2304 live tokens, bf16 pools
    x = latent_case(dev, mb=64, lens=[544, 65, 300, 400, 97, 512, 130, 256])
    args, kw = _latent_args(x)
    ev_ms = time_ms(lambda: pa.paged_latent_attention_cuda(*args, **kw),
                    flush)
    prof_ms = kernel_ms(lambda: pa.paged_latent_attention_cuda(*args, **kw),
                        flush, ("paged_latent_attention_kernel",))
    ms = ev_ms if prof_ms is None else prof_ms
    plain_ms = time_ms(lambda: pa.paged_latent_attention_plain(*args, **kw),
                       flush, reps=3)
    # SDPA on gathered rows: q = [q_lat, q_rope], k = [c_kv, k_rope]
    # shared by all heads, v = c_kv, the MLA scale passed
    ckg = paged.gather_blocks(x["ck_pool"], x["block_table"]).float()
    krg = paged.gather_blocks(x["kr_pool"], x["block_table"]).float()
    h = x["q_lat"].shape[2]
    kq = torch.cat([ckg, krg], dim=-1)[:, None].expand(-1, h, -1, -1)
    vq = ckg[:, None].expand(-1, h, -1, -1)
    qq = torch.cat([x["q_lat"], x["q_rope"].float()], dim=-1).transpose(1, 2)
    kpos = torch.arange(ckg.shape[1], device=dev)
    mask = (kpos[None, :] < x["lens"][:, None])[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qq, kq, vq, attn_mask=mask, scale=x["scale"]), flush)
    nbytes = pa.latent_bytes_moved(x["q_lat"], x["q_rope"], x["ck_pool"],
                                   x["kr_pool"], x["block_table"], x["lens"])
    flops = pa.latent_flops(x["q_lat"], x["q_rope"], x["q_offsets"])
    b_ms, b_by = bound(nbytes, flops)
    out["paged_latent_attention"] = dict(ms=ms, plain_ms=plain_ms,
                                         bound_ms=b_ms, bound_by=b_by,
                                         library_ms=lib_ms)
    log(f"[times] paged_latent_attention B=8 W=1 H=128 C=512 R=64 bs=16 "
        f"tokens={int(x['lens'].sum())}: kernel {ms:.4f} ms (profiler "
        f"device time {prof_ms}, event median {ev_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, SDPA on gathered rows {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes} B = {1e3 * nbytes / HBM_BYTES_PER_S:.4f} "
        f"ms, {flops} flop = {1e3 * flops / F32_FLOPS_PER_S:.4f} ms)")
    return out


# card-vs-CPU bound of the small check, and why: the f32 summation order
# differs (cuBLAS and the kernels vs the CPU's GEMMs and plain twins); at
# this seed no bf16 intermediate flips (for deepseek-v2 that includes the
# MoE router's logits, so routing is identical). The measured differences
# on an H100 are 1.19e-06 (qwen1.5) and 7.15e-07 (deepseek-v2), so ~8x
# and ~14x that: a bf16 flip (a jump of order 1e-2) fails the check.
SMALL_TOL = 1e-5
SMALL_ARCHS = ("qwen1.5-0.5b", "deepseek-v2-236b")


def small_config(arch: str):
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(arch)).with_(vocab_size=512)
    return cfg.with_(num_kv_heads=2) if cfg.mla is None else cfg


def phase_small(dev, arch: str) -> float:
    """A reduced model served on the card and on the CPU from the same
    weights: the same prompt, teacher-forced, logits agree."""
    import torch
    from repro_torch.models import api, paged
    cfg = small_config(arch)
    params_cpu = api.init_params(cfg, device="cpu", seed=SEED)
    params_gpu = api.to_device(params_cpu, dev)
    kv = api.KVCache.build(cfg, max_context=64, block_size=16, max_slots=1)
    prompt = torch.randint(0, 512, (1, 37), generator=torch.Generator()
                           .manual_seed(SEED), dtype=torch.int32)
    worst, toks = 0.0, []
    caches = {}
    for d in ("cpu", dev):
        caches[d] = kv.init(1, device=d)
        paged.reset_slot(caches[d], 0, torch.arange(1, 5, dtype=torch.int32,
                                                    device=d))
    lc = api.prefill_chunk_fn(cfg)(params_cpu, prompt, caches["cpu"], 0, 0)
    lgp = api.prefill_chunk_fn(cfg)(params_gpu, prompt.to(dev), caches[dev],
                                    0, 0)
    for step in range(6):
        worst = max(worst, float((lgp.cpu() - lc).abs().max()))
        tok = int(lc[0].argmax())
        toks.append(tok)
        t = torch.tensor([[tok]], dtype=torch.int32)
        lc = api.decode_fn(cfg)(params_cpu, t, caches["cpu"])
        lgp = api.decode_fn(cfg)(params_gpu, t.to(dev), caches[dev])
    tol = SMALL_TOL
    log(f"[small] reduced {arch} ({cfg.num_layers} layers, d={cfg.d_model}, "
        f"vocab 512) card vs CPU, prefill 37 + 6 decode steps: max|logit "
        f"diff| {worst:.4g} (tol {tol}); tokens {toks}")
    if not worst <= tol:
        fail(f"card and CPU disagree on the reduced {arch}")
    return worst


def make_requests(cfg, n: int = 16, new_tokens: int = 32):
    """The serve phases' traffic: seeded prompts of 64-512 tokens."""
    import torch
    from repro_torch.serving.engine import Request
    rng = torch.Generator().manual_seed(SEED)
    reqs = []
    for i in range(n):
        k = int(torch.randint(64, 513, (1,), generator=rng))
        prompt = torch.randint(0, cfg.vocab_size, (k,), generator=rng)
        reqs.append(Request(rid=i, prompt=prompt.tolist(),
                            max_new_tokens=new_tokens))
    return reqs


def phase_serve(dev, kind: str, cfg, what: str):
    """One main path: ``cfg`` behind ``DecodeEngine`` on the card. The
    launch counters are zeroed just before the 16 requests run and read
    just after; each decode step must have launched the model's attention
    kernel once per layer and the reduction twice, plus twice per
    request's first token."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serving.engine import DecodeEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, device=dev, seed=SEED)
    engine = DecodeEngine(cfg, params, max_slots=8, max_context=1024,
                          block_size=16, prefill_chunk=256, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = make_requests(cfg)
    step_ms = []
    decode_step = engine._decode_step

    def timed_decode_step():
        t = time.perf_counter()
        decode_step()                 # ends in the step's host transfer
        step_ms.append(1e3 * (time.perf_counter() - t))

    engine._decode_step = timed_decode_step
    for r in reqs:
        engine.submit(r)
    ops.reset_launches()
    t0 = time.perf_counter()
    engine.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    engine._decode_step = decode_step   # the profile window is not timed
    step_med = statistics.median(step_ms)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    st = engine.kv_stats
    emitted = sum(len(r.output) for r in reqs)
    log(f"[serve] {what} on {kind}: 16 requests, prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, {emitted} tokens "
        f"emitted in {wall:.3f} s = {emitted / wall:.2f} tok/s; "
        f"{st['decode_steps']} decode steps, median step "
        f"{step_med:.3f} ms; {st['prefill_chunks']} prefill chunks; "
        f"set-up {setup_s:.2f} s; peak device memory {peak_gib:.2f} GiB")
    log(f"[serve] launching wrapper calls {launches} (each fused_reduce "
        f"call launches reduce_pass1 and reduce_pass2); guard trips "
        f"{st['guard_trips']}")
    if not all(r.done and len(r.output) == 32 for r in reqs):
        fail("a request did not finish with its full output")
    if st["guard_trips"] or engine.quarantined:
        fail("the numerics guard tripped (non-finite or round-off logits)")
    stats = engine.last_logit_stats
    if not all(bool(torch.isfinite(torch.as_tensor(v)).all())
               for v in stats.values()):
        fail("non-finite logit statistics")
    attn = "paged_latent_attention" if cfg.mla is not None \
        else "paged_attention"
    want = dict.fromkeys(launches, 0)
    want[attn] = cfg.num_layers * st["decode_steps"]
    want["fused_reduce"] = 2 * (st["decode_steps"] + len(reqs))
    if launches != want:
        fail(f"launch counters {launches} != {want}")
    profile_decode(engine, cfg)
    log(f"[serve] peak device memory with the profiled window "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return launches, emitted / wall, step_med


def profile_decode(engine, cfg, n_steps: int = 4) -> None:
    """A steady decode window under ``torch.profiler``: 8 fresh requests
    (256-token prompts) are prefilled, then ``n_steps`` engine steps (pure
    decode, all 8 slots busy) are traced. Prints the device busy time per
    step, the device idle share of the window's wall time, kernels
    launched per step, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request
    g = torch.Generator().manual_seed(SEED + 1)
    for i in range(engine.max_slots):
        prompt = torch.randint(0, cfg.vocab_size, (256,), generator=g)
        engine.submit(Request(rid=100 + i, prompt=prompt.tolist(),
                              max_new_tokens=n_steps + 2))
    while engine.scheduler.waiting or engine.scheduler.prefilling:
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    kern = _device_kernels(prof)
    if not kern:
        log("[profile] torch.profiler recorded no device kernels")
        return
    busy_ms = sum(_device_us(ev) for ev in kern) / 1e3 / n_steps
    per_step = sum(ev.count for ev in kern) / n_steps
    log(f"[profile] {cfg.name} decode window, {n_steps} steps x 8 slots: wall "
        f"{wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step, "
        f"device idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{per_step:.0f} kernels/step")
    for ev in sorted(kern, key=_device_us, reverse=True)[:10]:
        log(f"[profile]   {_device_us(ev) / 1e3 / n_steps:8.3f} ms/step "
            f"{ev.count / n_steps:6.1f}/step  {ev.key[:90]}")
    engine.run_until_done()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs one CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    import repro_torch  # noqa: F401  (fails when run outside the repo)
    from repro_torch import device as _device
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    _device.set_numerics()
    kind, _ = phase_device()
    phase_build()
    attn_err = phase_attention_parity(dev)
    lat_err = phase_latent_parity(dev)
    red_err = phase_reduce_parity(dev)
    times = phase_times(dev)
    for arch in SMALL_ARCHS:
        phase_small(dev, arch)
    qwen = get_config("qwen1.5-0.5b")
    q_launch, q_tok_s, q_step = phase_serve(
        dev, kind, qwen, "qwen1.5-0.5b full width (24 L, d 1024, 16 H, "
        f"vocab 151936, random weights seed {SEED})")
    # deepseek-v2 at full width, depth cut to 3 (1 dense + 2 MoE layers):
    # 60 layers are 236 B parameters; 3 layers are ~9.3 B, 37 GB in f32
    ds = get_config("deepseek-v2-236b").with_(num_layers=3)
    d_launch, d_tok_s, d_step = phase_serve(
        dev, kind, ds, "deepseek-v2-236b full width, 3 L (1 dense + 2 MoE; "
        "d 5120, MLA 128 H kv_lora 512 rope 64, 160 experts top-6 + 2 "
        f"shared, vocab 102400; random weights seed {SEED})")
    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:307",
             launches=q_launch["paged_attention"], max_abs_err=attn_err,
             **times["paged_attention"]),
        dict(name="fused_reduce", route="cuda",
             source="src/repro_torch/csrc/fused_reduce.cu",
             replaces="src/repro/kernels/engine.py:327",
             launches=q_launch["fused_reduce"] + d_launch["fused_reduce"],
             launches_by_path={"qwen1.5-0.5b": q_launch["fused_reduce"],
                               "deepseek-v2-236b": d_launch["fused_reduce"]},
             max_abs_err=red_err, **times["fused_reduce"],
             flat=dict(replaces="src/repro/kernels/engine.py:282",
                       **times["fused_reduce_flat"])),
        dict(name="paged_latent_attention", route="cuda",
             source="src/repro_torch/csrc/paged_latent_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:354",
             launches=d_launch["paged_latent_attention"],
             max_abs_err=lat_err, **times["paged_latent_attention"]),
    ]
    log(f"[serve] qwen1.5-0.5b: tok/s {q_tok_s:.3f}, median decode step "
        f"{q_step:.3f} ms; deepseek-v2-236b (3 L): tok/s {d_tok_s:.3f}, "
        f"median decode step {d_step:.3f} ms")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
