"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device  — the card's name and ``nvidia-smi`` name / power limit;
2. build   — compiles ``src/repro_torch/csrc/*.cu`` (one nvcc each, in
             parallel) into ``build/kernels``, counts the HGMMA
             instructions of every tensor-core kernel (flash bf16 and
             f32, the matmul's tile route, the MLA latent split kernel;
             fails on none), and reads those libraries' registers, stack
             frames and local memory (fails on a spill);
3. parity  — each CUDA kernel against its plain PyTorch twin on the card,
             with the tolerance and its reason: the GQA attention kernel
             and the MLA latent attention kernel (every pool format, W in
             {1, 5}, partition-edge lengths; width, batch and table-width
             invariance bitwise), the reduction at main-path shapes (and
             its own guarantees: each row bitwise its B = 1 call, two
             calls bitwise equal, the arrival counters zero after); the
             compensated accumulate (bitwise), the compensated matmul and
             its int8 / fp8 form on both routes (tile, wgmma; split over
             K blocks where M <= 64) for every dtype pair, plus an
             ill-conditioned K = 2^14 case against an f64 product on each
             route, within 1.5x naive f32's error and 2x the reference's
             own (pinned by the CPU tests); and flash attention on its
             two routes (bf16 and f32 on the tensor cores) at head dims
             from 8 to 128, multiples of 16 or not (causal or not, ragged
             lengths, one-row and one-key calls);
4. path    — the kernel entry points of ``repro_torch.kernels`` at
             qwen1.5-0.5b's full widths, each with its launch counters
             zeroed just before and read just after: flash attention of
             four 2048-token prompts ([64, 2048, 64] causal, and at a
             head dim of 40, bf16 and f32 on the tensor cores), the
             paper's scalar products on 2^24 pairs through
             ``ops.kahan_dot`` / ``kahan_sum`` / ``naive_dot`` and the
             blocked shims, the down projection with compensated K
             accumulation (f32 and bf16, M = 2048 on the tile route and
             M = 8 on the split route), int8 / fp8 MLP weights at M = 8
             (split) and 2048 (tile), and 4 microbatches of gradients
             accumulated into every leaf of the parameter tree (bitwise
             ``KahanState.add``);
5. times   — device time of each kernel and of each library yardstick
             (``torch.profiler``, L2 flushed before each launch; the
             CUDA-event median printed beside it), the event median of
             the plain twin, beside the least time the card could take
             (HBM 3.35 TB/s, f32 CUDA-core 67 TFLOP/s, bf16 tensor
             cores 989 TFLOP/s; H100 SXM data sheet); a row whose
             profiler window shows none of its kernels fails, and so does
             a fused_reduce call that launches more than one kernel;
6. small   — reduced qwen1.5 and reduced deepseek-v2 served on the card
             and on the CPU (plain twins) from the same weights: logits
             agree;
7. serve   — two main paths behind ``DecodeEngine``, each with its launch
             counters zeroed just before and read just after: full-width
             qwen1.5-0.5b (24 layers) and full-width deepseek-v2-236b cut
             to 3 layers (1 dense + 2 MoE; MLA latent pools), random
             seeded weights, 8 slots, 16 requests of 64-512 prompt tokens,
             32 new tokens each; the counters must match the decode-step
             count; then a profiled decode window of each, used only when
             it holds every paged-attention launch it should and one
             fused_reduce kernel per reduction call.

The last two lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``. Imports nothing of ``jax`` or of the
reference package ``repro``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
F32_FLOPS_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM, bf16 tensor cores, dense
SEED = 0


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def bound(nbytes: float, flops: float, f32_flops: float = 0.0,
          rate: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for the work and what bounds it: ``flops`` at
    ``rate`` (the peak for the inputs' type) plus ``f32_flops`` at the
    f32 rate, against the bytes at the HBM rate."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / rate + f32_flops / F32_FLOPS_PER_S
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


def _profiled(fn, flush, reps: int):
    """``torch.profiler`` over ``reps`` calls of ``fn``, each after an L2
    flush when ``flush`` is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    return prof


# profiler windows that lost device events (see kernel_ms), and the rows
# timed by CUDA events because every try lost some: each is logged when it
# happens, and both lists are printed after the times
DROPPED_WINDOWS: list[str] = []
EVENT_TIMED: list[str] = []
PROFILE_TRIES = 5


def _launches(fn, flush, reps: int) -> dict:
    """Device kernels of a profiler window over ``fn``: key -> (launches,
    device us)."""
    return {ev.key: (ev.count, _device_us(ev))
            for ev in _device_kernels(_profiled(fn, flush, reps))}


def kernel_ms(fn, flush, names=None, reps: int = 20,
              what: str = "") -> float:
    """Mean device time (ms) per call of ``fn`` from ``torch.profiler``,
    the L2 flushed before each call: the kernels whose names contain one
    of ``names`` or, with ``names`` None (a library call), every kernel
    the call launches. The flush's own kernels never count, and a library
    call that launches one of them fails, as does a window that shows
    none of the call's kernels.

    The tracer now and then records nothing for a few tens of ms, so a
    window can lose some or all of its device events (PERF.md section 7,
    ``tools/profiler_windows.py``). A window is used only when it holds
    exactly ``reps`` times the launches that one flush and one call show
    in windows of their own; otherwise all three are profiled again after
    a pause, ``PROFILE_TRIES`` times at most, and then the row is timed by
    CUDA events (``time_ms``), logged and listed in ``EVENT_TIMED``."""
    import torch
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        one_flush = _launches(flush.zero_, None, 1)
        one_call = _launches(fn, None, 1)
        window = _launches(fn, flush, reps)
        got = {key: n for key, (n, _) in window.items()}
        want = {key: reps * (one_flush.get(key, (0,))[0]
                             + one_call.get(key, (0,))[0])
                for key in one_flush.keys() | one_call.keys()}
        if one_flush and got == want:
            break
        DROPPED_WINDOWS.append(what)
        log(f"[times] {what}: try {attempt + 1}: the profiler lost device "
            f"events (launches: one flush {sorted(one_flush)}, one call "
            f"{sorted(one_call)}, {reps} of both {sorted(got.items())}); "
            f"profiling again")
        time.sleep(0.5)
    else:
        ms = time_ms(fn, flush, reps=reps)
        EVENT_TIMED.append(what)
        log(f"[times] {what}: every profiler try lost device events; timed "
            f"by CUDA events instead: {ms:.4f} ms (event median)")
        return ms
    if names is None:
        if one_call.keys() & one_flush.keys():
            fail(f"{what}: the call launches the L2 flush's kernel "
                 f"{sorted(one_call.keys() & one_flush.keys())}, so its "
                 f"time cannot be told apart")
        pick = set(one_call)
    else:
        pick = {key for key in one_call if any(n in key for n in names)}
    pick -= one_flush.keys()
    if not pick:
        fail(f"{what}: the profiler window showed {sorted(got.items())} but "
             f"none of {list(names) if names else 'the call alone launches'}")
    return sum(window[key][1] for key in pick) / reps / 1e3


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
    block table; q_lat f32 (the absorbed query), q_rope bf16; ``fmt``
    bf16, int8, fp8 or f32 pools."""
    import torch
    from repro_torch.quant import core as qcore
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = 1 + b * mb
    ck = torch.randn((nb, bs, c), generator=g, device=dev)
    kr = torch.randn((nb, bs, r), generator=g, device=dev)
    qf = None if fmt == "f32" else qcore.get_format(fmt)
    if fmt == "f32":
        cs = rs = None
    elif qf is None:
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


def sass_counts(name: str, op: str) -> dict:
    """{kernel: SASS instructions whose opcode starts with ``op``} in the
    built library of ``csrc/<name>.cu`` (``cuobjdump`` of the toolkit that
    built it)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build._target(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if ln.strip().startswith("Function :"):
            fn = ln.split(":", 1)[1].strip()
            counts.setdefault(fn, 0)
            continue
        words = ln.split("*/", 1)[-1].split()   # /*addr*/ [@P] OPCODE ...
        if words and words[0].startswith("@"):        # a predicate
            words = words[1:]
        if fn is not None and words and words[0].startswith(op):
            counts[fn] += 1
    return counts


def res_usage(name: str) -> dict:
    """{kernel: (registers, stack frame bytes, local bytes)} of the built
    library of ``csrc/<name>.cu``, read by ``cuobjdump -res-usage`` (a
    spill needs a stack frame)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-res-usage", str(_build._target(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return {f: (int(r), int(st), int(lo)) for f, r, st, lo in re.findall(
        r"Function (\S+?):\s+REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)",
        text)}


# the tensor-core kernels: (library, a substring of the kernels' names)
TENSOR_CORE_KERNELS = (("flash_attention_wgmma", "flash_attention_wgmma_kernel"),
                       ("flash_attention_wgmma", "flash_attention_wgmma_f32"),
                       ("kahan_matmul", "kahan_matmul_tile_kernel"),
                       ("paged_latent_attention",
                        "paged_latent_attention_split"))


def phase_build():
    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"[build] {', '.join(_build.SOURCES)} -> {_build.build_dir()} "
        f"in {secs:.1f} s")
    for name, out in _build.BUILD_LOG.items():
        for ln in out.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower() \
                    or "warning" in ln.lower():
                log(f"[build] {name}: {ln.strip()}")
    for lib, kern in TENSOR_CORE_KERNELS:
        counts = {fn: n for fn, n in sass_counts(lib, "HGMMA").items()
                  if kern in fn}
        log(f"[build] {lib}: {sum(counts.values())} HGMMA (wgmma) "
            f"instructions in the SASS of its {len(counts)} {kern} kernels")
        if not counts or not all(counts.values()):
            fail(f"a {kern} kernel of {lib}.cu has no HGMMA instruction")
    # registers and spills of the tensor-core kernels from the libraries
    # themselves, so a run that finds them already built checks them too
    for lib in sorted({lib for lib, _ in TENSOR_CORE_KERNELS}):
        usage = res_usage(lib)
        if not usage:
            fail(f"cuobjdump -res-usage listed no {lib} kernel")
        for fn, (regs, stack, local) in sorted(usage.items()):
            log(f"[build] {lib}: {fn} REG {regs} STACK {stack} LOCAL "
                f"{local}")
        spilled = [fn for fn, (_, stack, local) in usage.items()
                   if stack or local]
        log(f"[build] {lib}: {len(usage)} kernels, registers "
            f"{min(r for r, _, _ in usage.values())}-"
            f"{max(r for r, _, _ in usage.values())}, {len(spilled)} with a "
            f"stack frame or local memory")
        if spilled:
            fail(f"{lib} kernels spill: {spilled}")


def _paged_call(x, sl=slice(None), mb=None, q=None, lens=None, offs=None):
    """paged_attention_cuda on the sequences ``sl`` of case ``x``, the
    table cut to its first ``mb`` slots when given."""
    from repro_torch.kernels import paged_attention as pa
    table = x["block_table"][sl]
    if mb is not None:
        table = table[:, :mb]
    return pa.paged_attention_cuda(
        (x["q"] if q is None else q)[sl].contiguous(), x["kpool"],
        x["vpool"], table.contiguous(),
        (x["lens"] if lens is None else lens)[sl].contiguous(),
        (x["q_offsets"] if offs is None else offs)[sl].contiguous(),
        kscale=x["kscale"], vscale=x["vscale"])


def phase_attention_parity(dev) -> float:
    """B1 against its twin at 2 bf16 ulps: every pool format at W in
    {1, 5} with Hkv = 16 and Hkv = 4 (groups 4), lengths on the
    partition edges (63, 64, 65, 128 tokens: a partition is 4 slots of
    16), one-token contexts, a table width that is no multiple of the
    partition (30 slots). Bitwise on the card: width invariance (row j
    of a width-W call is the width-1 call at q_offsets + j), batch
    invariance (each sequence alone is itself within the batch of 8) and
    table-width invariance (the first 32 slots of a 64-slot table, all
    lengths within them)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    worst = 0.0
    edges = [63, 64, 65, 128, 1, 2, 16, 17]
    cases = [dict(fmt=f, w=w, hkv=hkv) for f in ("bf16", "int8", "fp8")
             for w in (1, 5) for hkv in (16, 4)]
    cases += [dict(fmt=f, w=w, lens=[max(e, w) for e in edges])
              for f in ("bf16", "int8", "fp8") for w in (1, 5)]
    cases += [dict(fmt=f, w=w, mb=30) for f in ("bf16", "fp8")
              for w in (1, 5)]
    for c in cases:
        x = attention_case(dev, **c)
        args = (x["q"], x["kpool"], x["vpool"], x["block_table"], x["lens"],
                x["q_offsets"])
        kw = dict(kscale=x["kscale"], vscale=x["vscale"])
        before = ops.launches["paged_attention"]
        got = pa.paged_attention_cuda(*args, **kw)
        want = pa.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        counted = ops.launches["paged_attention"] - before
        err = (got.float() - want.float()).abs()
        # both round one f32 result to bf16; the f32 results differ in
        # the summation order of the scores, the p sums and PV products
        # and in where the partitions are folded, so they may straddle a
        # bf16 rounding boundary: 2 bf16 ulps of the value
        tol = 2.0 ** -7 * want.float().abs() + 1e-6
        bad = int((err > tol).sum())
        worst = max(worst, float(err.max()))
        wid = c["w"]
        inv_w = all(torch.equal(got[:, j], _paged_call(
            x, q=x["q"][:, j:j + 1], lens=x["q_offsets"] + j + 1,
            offs=x["q_offsets"] + j)[:, 0]) for j in range(wid))
        inv_b = all(torch.equal(got[i:i + 1], _paged_call(
            x, slice(i, i + 1))) for i in range(got.shape[0]))
        log(f"[parity] paged_attention {c}: max|kernel-plain| "
            f"{float(err.max()):.3g} (tol 2 bf16 ulps: f32 summation order "
            f"before one bf16 rounding), {bad} over tol; bitwise width "
            f"invariance {inv_w}, batch invariance {inv_b}")
        if bad or not inv_w or not inv_b or counted != 1 or \
                not torch.isfinite(got.float()).all():
            fail(f"paged_attention parity {c}")
    # table width: a 64-slot table whose lengths fit its first 32 slots
    for fmt in ("bf16", "int8", "fp8"):
        for w in (1, 5):
            x = attention_case(dev, fmt=fmt, w=w, mb=64, lens=[
                512, w, 17, 259, 511, 128, 64, 129])
            wide = _paged_call(x)
            narrow = _paged_call(x, mb=32)
            ok = torch.equal(wide, narrow)
            log(f"[parity] paged_attention fmt={fmt} W={w}: mb 64 vs the "
                f"same first 32 slots, bitwise {ok}")
            if not ok:
                fail(f"paged_attention table-width invariance {fmt} W={w}")
    return worst


def _latent_call(x, sl=slice(None), mb=None, w=None, lens=None, offs=None):
    """paged_latent_attention_cuda on the sequences ``sl`` of case ``x``
    (query width ``w`` only, when given), the table cut to ``mb`` slots."""
    from repro_torch.kernels import paged_attention as pa
    table = x["block_table"][sl]
    if mb is not None:
        table = table[:, :mb]
    ws = slice(None) if w is None else slice(w, w + 1)
    return pa.paged_latent_attention_cuda(
        x["q_lat"][sl, ws].contiguous(), x["q_rope"][sl, ws].contiguous(),
        x["ck_pool"], x["kr_pool"], table.contiguous(),
        (x["lens"] if lens is None else lens)[sl].contiguous(),
        (x["q_offsets"] if offs is None else offs)[sl].contiguous(),
        ck_scale=x["ck_scale"], kr_scale=x["kr_scale"], scale=x["scale"])


def phase_latent_parity(dev) -> float:
    """B3 at the deepseek serve phase's shapes (B=8, H=128, C=512, R=64,
    bs=16, 64-block tables): bf16 / int8 / fp8 pools x W in {1, 5},
    permuted tables and ragged tails, lengths on the partition edges (a
    partition is 4 slots of 16: 63, 64, 65, 128 tokens) and an f32 pool,
    against its plain twin and the dequant-first oracle. Bitwise on the
    card: width invariance (row j of a width-W call is the width-1 call at
    q_offsets + j), batch invariance (each sequence alone is itself in the
    batch of 8) and table-width invariance (the first 32 slots of a
    64-slot table, all lengths within them)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    worst = 0.0
    edges = [63, 64, 65, 128, 1, 2, 16, 17]
    cases = [dict(fmt=f, w=w) for f in ("bf16", "int8", "fp8")
             for w in (1, 5)]
    cases += [dict(fmt=f, w=w, lens=[max(e, w) for e in edges])
              for f in ("bf16", "int8", "fp8") for w in (1, 5)]
    cases += [dict(fmt="f32", w=5)]
    for c in cases:
        w = c["w"]
        x = latent_case(dev, mb=64, **c)
        args, kw = _latent_args(x)
        before = ops.launches["paged_latent_attention"]
        got = pa.paged_latent_attention_cuda(*args, **kw)
        counted = ops.launches["paged_latent_attention"] - before
        want = pa.paged_latent_attention_plain(*args, **kw)
        oracle = latent_oracle(x)
        torch.cuda.synchronize()
        # f32 outputs of the same operations in another summation order
        # (the tensor cores' plane products, the partitions' merge): the
        # reference's own latent-kernel tolerance, 2e-4 abs + rel
        # (tests/test_superkernel.py), for the twin and the oracle
        err = (got - want).abs()
        err_o = (got.double() - oracle).abs()
        bad = int((err > 2e-4 + 2e-4 * want.abs()).sum())
        bad_o = int((err_o > 2e-4 + 2e-4 * oracle.abs()).sum())
        worst = max(worst, float(err.max()))
        inv_w = all(torch.equal(got[:, j], _latent_call(
            x, w=j, lens=x["q_offsets"] + j + 1,
            offs=x["q_offsets"] + j)[:, 0]) for j in range(w))
        inv_b = all(torch.equal(got[i:i + 1], _latent_call(
            x, slice(i, i + 1))) for i in range(got.shape[0]))
        log(f"[parity] paged_latent_attention {c}: max|kernel-plain| "
            f"{float(err.max()):.3g}, max|kernel-oracle| "
            f"{float(err_o.max()):.3g} (tol 2e-4 abs + 2e-4 rel: f32 "
            f"summation order), {bad} + {bad_o} over tol; bitwise width "
            f"invariance {inv_w}, batch invariance {inv_b}")
        if bad or bad_o or not inv_w or not inv_b or counted != 1 or \
                not torch.isfinite(got).all():
            fail(f"paged_latent_attention parity {c}")
    # table width: a 64-slot table whose lengths fit its first 32 slots
    for fmt in ("bf16", "int8", "fp8"):
        for w in (1, 5):
            x = latent_case(dev, fmt=fmt, w=w, mb=64, lens=[
                512, w, 17, 259, 511, 128, 64, 129])
            ok = torch.equal(_latent_call(x), _latent_call(x, mb=32))
            log(f"[parity] paged_latent_attention fmt={fmt} W={w}: mb 64 vs "
                f"the same first 32 slots, bitwise {ok}")
            if not ok:
                fail(f"paged_latent_attention table-width invariance {fmt} "
                     f"W={w}")
    # a long table: 1024 slots of 16 (256 partitions, eight chunks of the
    # split and merge); the scratch is one chunk's plus the state, read
    # from the allocator's peak, where the table's would be 8x that
    x = latent_case(dev, mb=1024, lens=[16384, 3000, 1, 8191, 4096, 12000,
                                        129, 16383])
    args, kw = _latent_args(x)
    rows, c = x["q_lat"].shape[1] * x["q_lat"].shape[2], x["q_lat"].shape[3]
    floats = pa.latent_scratch_floats(8, rows, c, 1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before_b = torch.cuda.memory_allocated(dev)
    before = ops.launches["paged_latent_attention"]
    got = pa.paged_latent_attention_cuda(*args, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before_b
    counted = ops.launches["paged_latent_attention"] - before
    want = pa.paged_latent_attention_plain(*args, **kw)
    oracle = latent_oracle(x)
    err = (got - want).abs()
    err_o = (got.double() - oracle).abs()
    bad = int((err > 2e-4 + 2e-4 * want.abs()).sum())
    bad_o = int((err_o > 2e-4 + 2e-4 * oracle.abs()).sum())
    worst = max(worst, float(err.max()))
    inv_b = all(torch.equal(got[i:i + 1], _latent_call(x, slice(i, i + 1)))
                for i in range(got.shape[0]))
    log(f"[parity] paged_latent_attention mb=1024 lens "
        f"{x['lens'].tolist()}: max|kernel-plain| {float(err.max()):.3g}, "
        f"max|kernel-oracle| {float(err_o.max()):.3g}, {bad} + {bad_o} over "
        f"tol; scratch {4 * floats / 2**20:.1f} MiB, call peak "
        f"{peak / 2**20:.1f} MiB (the whole table's partitions would be "
        f"{4 * floats * 256 / 33 / 2**20:.1f} MiB); bitwise "
        f"batch invariance {inv_b}")
    if bad or bad_o or not inv_b or counted != 1 or \
            peak > 4 * (floats + got.numel()) + (4 << 20) or \
            not torch.isfinite(got).all():
        fail("paged_latent_attention long table")
    return worst


# the (rows, vocab) shapes the two served paths hand the reduction: an
# 8-slot decode step and a request's first token, at qwen1.5's and
# deepseek-v2's vocab widths. The split geometry follows N alone: 151936
# gives 38 splits of 4096 with a ragged last one, 102400 gives 25 of 4096
# and no tail.
REDUCE_SHAPES = ((8, 151936), (1, 151936), (8, 102400), (1, 102400))


def phase_reduce_parity(dev) -> float:
    import torch
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for rows, n in REDUCE_SHAPES:
        worst = max(worst, reduce_rows_parity(dev, g, rows, n),
                    ill_conditioned_reduce(dev, g, rows, n))
    reduce_invariance(dev, g)
    # the flat form (B2f) is checked on the path, by phase_flat_path
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
                nsplit, seg = engine.splits(n)
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


def reduce_invariance(dev, g) -> None:
    """The one-launch kernel's own guarantees, each fatal if broken: row i
    of a B = 8 call is bitwise a B = 1 call on that row (the splits depend
    on N alone), two calls give the same bits (the last CTA folds the
    partials in a fixed order, whichever arrives last), and the arrival
    counters read zero after every call."""
    import torch
    from repro_torch.kernels import engine
    n = 151936
    x = (torch.randn((8, n), generator=g, device=dev) * 4.0 + 1.0)
    y = torch.randn((8, n), generator=g, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for outs, comp in ((("max", "sum", "sumsq"), True), (("dot",), True),
                       (("sum", "maxabs"), False)):
        ops = (x, y) if "dot" in outs else (x,)
        first = engine.fused_reduce_rows_cuda(ops, outputs=outs,
                                              compensated=comp)
        again = engine.fused_reduce_rows_cuda(ops, outputs=outs,
                                              compensated=comp)
        rows = [engine.fused_reduce_rows_cuda(
            tuple(op[i:i + 1] for op in ops), outputs=outs, compensated=comp)
            for i in range(8)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        by_row = all(torch.equal(a[i:i + 1], r[k])
                     for i, r in enumerate(rows)
                     for k, a in enumerate(first))
        counters = int(engine._COUNTERS[(x.device.index, stream)]
                       .count_nonzero())
        log(f"[parity] fused_reduce [8,{n}] {outs} compensated={comp}: two "
            f"calls bitwise equal {same}; each row bitwise its B = 1 call "
            f"{by_row}; arrival counters non-zero after the calls: "
            f"{counters}")
        if not (same and by_row and counters == 0):
            fail(f"fused_reduce invariance {outs} compensated={comp}")


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


def time_row(flush, name, run, plain, lib, kernel_names, nbytes, flops,
             f32_flops, rate, what, plain_reps=3) -> dict:
    """One times row: the kernel's and the library call's profiler device
    time (L2 flushed before each call; the CUDA-event median printed
    beside each), the plain twin's event median (the twin repeats the
    kernel's arithmetic and is no yardstick of speed), and the bound."""
    ms = kernel_ms(run, flush, kernel_names, what=name)
    ev = time_ms(run, flush)
    plain_ms = time_ms(plain, flush, reps=plain_reps)
    lib_ms = lib_ev = None
    if lib is not None:
        lib_ms = kernel_ms(lib, flush, None, what=f"{name} library")
        lib_ev = time_ms(lib, flush)
    b_ms, b_by = bound(nbytes, flops, f32_flops, rate)
    lib_txt = "none" if lib is None else \
        f"{lib_ms:.4f} ms (event median {lib_ev:.4f})"
    log(f"[times] {name} {what}: kernel {ms:.4f} ms (profiler device time "
        f"of {', '.join(kernel_names)}; event median {ev:.4f}), plain "
        f"{plain_ms:.4f} ms (event median), library {lib_txt}, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {flops + f32_flops} flop)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


PAGED_KERNELS = ("paged_attention_split_kernel",
                 "paged_attention_merge_kernel")
LATENT_KERNELS = ("paged_latent_attention_split_kernel",
                  "paged_latent_attention_merge_kernel")


def phase_times(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import engine
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import paged
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    out = {}
    # paged attention at the serve phase's decode shapes (B = 8 slots,
    # 64-block tables, ragged contexts up to 544 tokens); the library is
    # SDPA on the gathered rows with a length mask
    x = attention_case(dev, mb=64,
                       lens=[544, 65, 300, 400, 97, 512, 130, 256])
    args = (x["q"], x["kpool"], x["vpool"], x["block_table"], x["lens"],
            x["q_offsets"])
    kg = paged.gather_blocks(x["kpool"], x["block_table"]).transpose(1, 2)
    vg = paged.gather_blocks(x["vpool"], x["block_table"]).transpose(1, 2)
    kpos = torch.arange(kg.shape[2], device=dev)
    mask = (kpos[None, :] < x["lens"][:, None])[:, None, None, :]
    qs = x["q"].transpose(1, 2)
    live_tok = int(x["lens"].sum())
    out["paged_attention"] = time_row(
        flush, "paged_attention", lambda: pa.paged_attention_cuda(*args),
        lambda: pa.paged_attention_plain(*args),
        lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask),
        PAGED_KERNELS,
        pa.bytes_moved(x["q"], x["kpool"], x["vpool"], x["block_table"],
                       x["lens"]),
        0, 4 * live_tok * x["q"].shape[2] * x["q"].shape[3],
        F32_FLOPS_PER_S,
        f"B=8 W=1 Hq=Hkv=16 D=64 bs=16 tokens={live_tok} bf16 pools, "
        f"split + merge (library: SDPA on gathered rows)", plain_reps=5)
    # fused reduce at the decode step's first call: [8, 151936] f32,
    # (max, sum, sumsq); no single PyTorch call computes the compensated
    # fused statistics. One call must launch exactly one kernel.
    g = torch.Generator(device=dev).manual_seed(3)
    lg = torch.randn((8, 151936), generator=g, device=dev)
    outs = ("max", "sum", "sumsq")
    b2 = lambda: engine.fused_reduce_rows_cuda((lg,), outputs=outs)  # noqa: E731
    for _ in range(PROFILE_TRIES):      # a window may lose its events
        one = _launches(b2, None, 1)
        if one:
            break
    log(f"[times] fused_reduce: one call launches {sorted(one.items())}")
    if sum(n for n, _ in one.values()) != 1 or \
            not all("fused_reduce_kernel" in k for k in one):
        fail(f"a fused_reduce call launched {sorted(one)}, not one kernel")
    out["fused_reduce"] = time_row(
        flush, "fused_reduce", b2,
        lambda: engine.fused_reduce_rows_plain((lg,), outputs=outs), None,
        ("fused_reduce_kernel",),
        engine.bytes_moved(8, 151936, 1, len(outs)), 0,
        8 * 151936 * (6 + 1 + 6 + 1), F32_FLOPS_PER_S,
        "[8,151936] (max,sum,sumsq), one launch (library: none)",
        plain_reps=5)
    # the flat form (fused_reduce_flat): one compensated dot of 2^24 f32
    # pairs, the parity phase's shape, beside the same kernel with
    # compensated=False (the paper's baseline) and torch.dot (the same
    # function, uncompensated)
    n = 1 << 24
    a = torch.randn(n, generator=g, device=dev)
    b = torch.randn(n, generator=g, device=dev)
    out["fused_reduce_flat"] = time_row(
        flush, "fused_reduce_flat",
        lambda: engine.fused_reduce_flat((a, b), outputs=("dot",)),
        lambda: engine.fused_reduce_flat_plain((a, b), outputs=("dot",)),
        lambda: torch.dot(a, b), ("fused_reduce_kernel",),
        engine.bytes_moved(1, n, 2, 1), 0, n * 8, F32_FLOPS_PER_S,
        "dot n=2^24, one launch (library: torch.dot, uncompensated)")
    naive = kernel_ms(lambda: engine.fused_reduce_flat(
        (a, b), outputs=("dot",), compensated=False), flush,
        ("fused_reduce_kernel",), what="fused_reduce_flat naive")
    flat = out["fused_reduce_flat"]
    flat["naive_ms"] = naive
    log(f"[times] fused_reduce_flat dot n=2^24: compensated {flat['ms']:.4f} "
        f"ms, the same kernel with compensated=False {naive:.4f} ms "
        f"(compensated / naive {flat['ms'] / naive:.3f}), torch.dot "
        f"{flat['library_ms']:.4f} ms (compensated / torch.dot "
        f"{flat['ms'] / flat['library_ms']:.3f}); profiler device time, L2 "
        f"flushed")
    # the latent (MLA) kernel at the deepseek serve phase's decode shape:
    # B = 8 slots, W = 1, H = 128, C = 512, R = 64, bs = 16, 64-block
    # tables, 2304 live tokens, bf16 pools; SDPA on gathered rows: q =
    # [q_lat, q_rope], k = [c_kv, k_rope] shared by all heads, v = c_kv,
    # the MLA scale passed
    x = latent_case(dev, mb=64, lens=[544, 65, 300, 400, 97, 512, 130, 256])
    largs, kw = _latent_args(x)
    ckg = paged.gather_blocks(x["ck_pool"], x["block_table"]).float()
    krg = paged.gather_blocks(x["kr_pool"], x["block_table"]).float()
    h = x["q_lat"].shape[2]
    kq = torch.cat([ckg, krg], dim=-1)[:, None].expand(-1, h, -1, -1)
    vq = ckg[:, None].expand(-1, h, -1, -1)
    qq = torch.cat([x["q_lat"], x["q_rope"].float()], dim=-1).transpose(1, 2)
    kpos = torch.arange(ckg.shape[1], device=dev)
    lmask = (kpos[None, :] < x["lens"][:, None])[:, None, None, :]
    nbytes = pa.latent_bytes_moved(x["q_lat"], x["q_rope"], x["ck_pool"],
                                   x["kr_pool"], x["block_table"], x["lens"])
    out["paged_latent_attention"] = time_row(
        flush, "paged_latent_attention",
        lambda: pa.paged_latent_attention_cuda(*largs, **kw),
        lambda: pa.paged_latent_attention_plain(*largs, **kw),
        lambda: F.scaled_dot_product_attention(qq, kq, vq, attn_mask=lmask,
                                               scale=x["scale"]),
        LATENT_KERNELS, nbytes,
        pa.latent_tensor_flops(x["q_lat"], x["q_rope"], x["ck_pool"],
                               x["q_offsets"]), 0, BF16_FLOPS_PER_S,
        f"B=8 W=1 H=128 C=512 R=64 bs=16 tokens={int(x['lens'].sum())}, "
        f"split + merge, bf16 tensor-core passes (library: SDPA on "
        f"gathered rows, f32)")
    # the bound of the same work with f32 products on the CUDA cores, for
    # the log only (the kernels line carries measured times and bound_ms)
    log(f"[times] paged_latent_attention: the same work on the CUDA cores "
        f"(f32 products) would be bound at "
        f"""{bound(nbytes, 0, pa.latent_flops(x["q_lat"], x["q_rope"],
                                            x["q_offsets"]))[0]:.4f} ms""")
    return out


# ------------------------------------------------- the kernel-entry slice --
# B4-B7 (flash attention, compensated matmul and its q8 form, compensated
# accumulate): parity against the plain twins on the card, the path that
# drives each entry point of repro_torch.kernels at qwen1.5-0.5b's full
# widths with its launch counters, and the times.

def _module(name: str):
    """A kernel module of ``repro_torch.kernels`` (the package rebinds
    ``kahan_matmul`` and ``flash_attention`` to the entry functions)."""
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")


def _randn(g, shape, dev, dtype=None):
    import torch
    x = torch.randn(shape, generator=g, device=dev)
    return x if dtype is None else x.to(dtype)


def phase_acc_parity(dev) -> float:
    """B7 bitwise against its twin: aligned (float4 path) and unaligned
    (scalar path) tensors, f32 and bf16 updates."""
    import torch
    from repro_torch.kernels import kahan_acc as ka
    g = torch.Generator(device=dev).manual_seed(5)
    for n, off in ((1 << 22, 0), (4099, 1), (1000003, 0)):
        s = _randn(g, (n + off,), dev) * 100.0
        c = _randn(g, (n + off,), dev) * 1e-5
        u = _randn(g, (n + off,), dev)
        for ud in (torch.float32, torch.bfloat16):
            ks, kc = s.clone()[off:], c.clone()[off:]
            ps, pc = s[off:].clone(), c[off:].clone()
            uu = u[off:].to(ud).contiguous()
            ka.kahan_acc_flat_cuda(ks, kc, uu)
            ka.kahan_acc_flat_plain(ps, pc, uu)
            torch.cuda.synchronize()
            ok = torch.equal(ks, ps) and torch.equal(kc, pc)
            log(f"[parity] kahan_acc n={n} offset={off} update={ud}: "
                f"bitwise (tol 0: adds only, the reference's op order): "
                f"{ok}")
            if not ok:
                fail(f"kahan_acc parity n={n} offset={off} {ud}")
    return 0.0


def phase_matmul_parity(dev) -> dict:
    """B5 and B6 against their twins at the CPU tests' tolerances on both
    routes (M picks one: route S for M <= 64), every dtype pair the
    wrappers take, and the ill-conditioned deep contraction against an
    f64 product. Returns the largest error per launch counter."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.quant import core as qcore
    km = _module("kahan_matmul")
    g = torch.Generator(device=dev).manual_seed(6)
    worst = {km.counter(q8, r): 0.0 for q8 in (False, True)
             for r in ("tile", "split")}

    def run(q8, m, fn):
        name = km.counter(q8, km.pick_route(m))
        before = ops.launches[name]
        got = fn()
        torch.cuda.synchronize()
        if ops.launches[name] != before + 1:
            fail(f"{name}: the call did not count one launch")
        return name, got

    # bk = 24 (M 67 and 61 x 120 x 100): a block that is no multiple of
    # 16, ragged M and N, on each route; M = 8 and 61 take route S
    shapes = [(128, 256, 128, 128, 128, 128), (256, 1024, 128, 128, 128, 256),
              (128, 128, 128, 64, 64, 32), (8, 2816, 1024, 8, 256, 256),
              (67, 120, 100, 67, 100, 24), (61, 120, 100, 61, 100, 24),
              (2048, 2816, 1024, 256, 256, 256)]
    for m, k, n, bm, bn, bk in shapes:
        for dt in (torch.float32, torch.bfloat16):
            a, b = _randn(g, (m, k), dev, dt), _randn(g, (k, n), dev, dt)
            kw = dict(block_m=bm, block_n=bn, block_k=bk)
            want = km.kahan_matmul_plain(a, b, **kw)
            name, got = run(False, m, lambda: km.kahan_matmul_cuda(a, b,
                                                                   **kw))
            err = (got - want).abs()
            # f32 block partials summed in other orders, the same folds:
            # the reference test's f32 tolerance 1e-5 sqrt(K) + 1e-5 rel
            tol = 1e-5 * k ** 0.5 + 1e-5 * want.abs()
            bad = int((err > tol).sum())
            worst[name] = max(worst[name], float(err.max()))
            log(f"[parity] {name} {m}x{k}x{n} bk={bk} {dt}: "
                f"max|kernel-plain| {float(err.max()):.3g} (tol 1e-5 "
                f"sqrt(K) + 1e-5 rel: summation order inside a K block), "
                f"{bad} over tol")
            if bad or not torch.isfinite(got).all():
                fail(f"{name} parity {m}x{k}x{n} {dt}")
    # the deep contraction of tests/test_kernels_matmul.py: K = 2^14,
    # magnitudes 1e-3..1e3, bk = 128; at M = 8 on route S, at M = 72 on
    # route T (the six-product form)
    k = 1 << 14
    sc = 10.0 ** torch.randint(-3, 4, (1, k), generator=g, device=dev)
    b = (_randn(g, (k, 8), dev) * sc.T).float()
    for m in (8, 72):
        a = (_randn(g, (m, k), dev) * sc).float()
        exact = a.double() @ b.double()
        err_n = float(((a @ b).double() - exact).abs().max())
        name, got = run(False, m, lambda: km.kahan_matmul_cuda(
            a, b, block_m=m, block_n=8, block_k=128))
        err_k = float((got.double() - exact).abs().max())
        ok = err_k <= 1.5 * err_n + 1e-6 and \
            err_k <= 1e-3 * float(exact.abs().max())
        log(f"[parity] {name} deep M={m} K=2^14 bk=128 ill-conditioned: "
            f"|kernel-f64| {err_k:.4g}, |naive f32 matmul-f64| {err_n:.4g} "
            f"(bound 1.5x naive and 1e-3 max|C| = "
            f"{1e-3 * float(exact.abs().max()):.4g}): {ok}")
        if not ok:
            fail(f"{name} deep contraction")
    # the same construction from the CPU tests' seed (numpy), whose
    # reference error the tests pin: besides the gates above, each route
    # within 2x the reference's own error on these inputs
    for m in (8, 72):
        a_np, b_np = km.deep_case(m)
        a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)
        exact = a.double() @ b.double()
        err_n = float(((a @ b).double() - exact).abs().max())
        name, got = run(False, m, lambda: km.kahan_matmul_cuda(
            a, b, block_m=m, block_n=8, block_k=128))
        err_k = float((got.double() - exact).abs().max())
        ref = km.DEEP_CASE_REFERENCE_ERR[m]
        ok = err_k <= 1.5 * err_n + 1e-6 and err_k <= 2 * ref and \
            err_k <= 1e-3 * float(exact.abs().max())
        log(f"[parity] {name} deep_case({m}) K=2^14 bk=128: |kernel-f64| "
            f"{err_k:.4g} = {err_k / ref:.2f}x the reference's {ref:.4g} "
            f"(bound 2x), naive f32 {err_n:.4g} (bound 1.5x): {ok}")
        if not ok:
            fail(f"{name} deep_case({m}) against the reference's error")
    for fmt, adt in ((qcore.INT8, torch.float32), (qcore.FP8, torch.float32),
                     (qcore.INT8, torch.bfloat16)):
        for m, k, n, bk in ((8, 512, 128, 256), (16, 256, 256, 256),
                            (67, 2816, 1024, 256), (67, 120, 100, 24),
                            (61, 120, 100, 24), (2048, 2816, 1024, 256)):
            a = _randn(g, (m, k), dev, adt)
            qw, s = qcore.quantize_weight(_randn(g, (k, n), dev), fmt,
                                          block_k=bk)
            want = km.kahan_matmul_q8_plain(a, qw, s, block_m=m)
            oracle = a.double() @ qcore.dequantize_weight(qw, s).double()
            name, got = run(True, m, lambda: km.kahan_matmul_q8_cuda(
                a, qw, s, block_m=m))
            err = (got - want).abs()
            err_o = (got.double() - oracle).abs()
            # the quant test's tolerance (tests/test_quant.py), widened by
            # sqrt(K / 512) for the deeper shapes
            atol = 1e-4 * max(1.0, (k / 512) ** 0.5)
            bad = int((err > atol + 1e-5 * want.abs()).sum())
            bad_o = int((err_o > atol + 1e-5 * oracle.abs()).sum())
            worst[name] = max(worst[name], float(err.max()))
            log(f"[parity] {name} {fmt.name} A {adt} {m}x{k}x{n} bk={bk}: "
                f"max|kernel-plain| {float(err.max()):.3g}, max|kernel-"
                f"dequant f64| {float(err_o.max()):.3g} (tol {atol:.3g} abs "
                f"+ 1e-5 rel), {bad} + {bad_o} over tol")
            if bad or bad_o or not torch.isfinite(got).all():
                fail(f"{name} parity {fmt.name} {adt} {m}x{k}x{n}")
    return worst


def phase_flash_parity(dev) -> dict:
    """B4 against its twin on its two routes, bf16 and f32 on the tensor
    cores, at every head dim up to 128: causal and not, ragged lengths
    (482 is a drawn prompt length of the serve phases), Lq != Lk, one-row
    and one-key calls, Dv != D, and D / Dv that are no multiple of 16 (8,
    24, 36, 40, 72, 100, 127: bf16 rows of 36, 100 and 127 elements and
    f32 rows of 127 are not 16-byte aligned). Returns the largest error
    per route."""
    import torch
    from repro_torch.kernels import ops
    fa = _module("flash_attention")
    g = torch.Generator(device=dev).manual_seed(7)
    worst = {"flash_attention_wgmma": 0.0, "flash_attention_wgmma_f32": 0.0}
    cases = [(482, 482, 64, 64, True), (482, 482, 64, 64, False),
             (130, 257, 64, 64, False), (3, 7, 64, 64, True),
             (100, 40, 32, 32, True), (40, 100, 32, 32, True),
             (256, 256, 128, 128, True), (1, 257, 64, 64, False),
             (1, 1, 64, 64, True), (257, 1, 64, 64, True),
             (200, 300, 64, 128, True), (200, 300, 128, 32, False),
             (130, 257, 40, 40, True), (100, 40, 40, 24, False),
             (130, 257, 8, 8, True), (64, 65, 24, 72, False),
             (200, 300, 36, 36, True), (3, 7, 36, 100, True),
             (130, 257, 72, 40, False), (257, 130, 100, 127, True),
             (100, 100, 127, 127, False), (1, 65, 127, 8, True),
             (482, 482, 40, 40, True)]
    for lq, lk, d, dv, causal in cases:
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q = _randn(g, (16, lq, d), dev, dt)
            k, v = _randn(g, (16, lk, d), dev, dt), _randn(g, (16, lk, dv),
                                                           dev, dt)
            route = fa.route(q, k, v)
            before = ops.launches[route]
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            counted = ops.launches[route] - before
            err = (got.float() - want.float()).abs()
            bad = int((err > tol + tol * want.float().abs()).sum())
            worst[route] = max(worst[route], float(err.max()))
            log(f"[parity] flash_attention BH=16 Lq={lq} Lk={lk} D={d} "
                f"Dv={dv} causal={causal} {dt} -> {route}: max|kernel-plain| "
                f"{float(err.max()):.3g} (tol {tol} abs + rel, the "
                f"reference test's: other tiling, other summation order"
                f"{', p rounded to bf16 for P V' if route.endswith('wgmma') else ''}"
                f"{', six plane products' if route.endswith('f32') else ''}"
                f"), {bad} over tol")
            if bad or counted != 1 or got.shape != (16, lq, dv) or \
                    not torch.isfinite(got.float()).all():
                fail(f"flash_attention parity Lq={lq} Lk={lk} D={d} Dv={dv} "
                     f"{dt}")
            # every D, Dv up to 128 takes the tensor-core route of its dtype
            tc = {torch.bfloat16: "flash_attention_wgmma",
                  torch.float32: "flash_attention_wgmma_f32"}[dt]
            if route != tc:
                fail(f"{dt} D={d} Dv={dv} took {route}")
    return worst


def _counted(what: str, fn, want: dict):
    """Run ``fn`` with the launch counters zeroed just before; fail unless
    they equal ``want`` (every other kernel 0) just after."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = dict(ops.launches)
    full = dict.fromkeys(got, 0)
    full.update(want)
    log(f"[path] {what}: launching wrapper calls {got}")
    if got != full:
        fail(f"{what}: launch counters {got} != {full}")
    return out


def phase_kernel_path(dev, qwen) -> tuple[dict, dict]:
    """The slice's path at qwen1.5-0.5b's full widths, through the entry
    points of ``repro_torch.kernels``; returns the launches per kernel
    and the inputs the times phase reuses."""
    import torch
    import repro_torch.kernels as K
    from repro_torch.core import kahan
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.kahan_matmul import (kahan_matmul_plain,
                                                  kahan_matmul_q8_plain)
    from repro_torch.models import api
    from repro_torch.quant import core as qcore
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    launches, fx = {}, {}
    # B4: prefill attention of four 2048-token prompts, 16 heads, D = 64,
    # bf16 and f32 on the tensor cores; and the same prompts with a head
    # dim of 40 (no multiple of 16: padded to a 64-wide panel in the kernel)
    bh, l, d = 4 * qwen.num_heads, 2048, qwen.head_dim
    for dt, name, key, dd in ((torch.bfloat16, "bf16", "flash", d),
                              (torch.float32, "f32", "flash_f32", d),
                              (torch.bfloat16, "bf16", "flash_40", 40),
                              (torch.float32, "f32", "flash_f32_40", 40)):
        q, k, v = (_randn(g, (bh, l, dd), dev, dt) for _ in range(3))
        route = _module("flash_attention").route(q, k, v)
        out = _counted(f"flash_attention [{bh}, {l}, {dd}] {name} causal",
                       lambda: K.flash_attention(q, k, v, causal=True),
                       {route: 1})
        want = flash_attention_plain(q, k, v, causal=True)
        err = float((out.float() - want.float()).abs().max())
        tol = 2e-2 if dt == torch.bfloat16 else 2e-5
        log(f"[path] flash_attention {name} D={dd} ({route}): out "
            f"{tuple(out.shape)} {out.dtype}, finite "
            f"{bool(torch.isfinite(out.float()).all())}, max|kernel-plain| "
            f"{err:.3g} (tol {tol}, {name})")
        if out.shape != (bh, l, dd) or out.dtype != dt or \
                not torch.isfinite(out.float()).all() or err > tol:
            fail(f"flash_attention path {name} D={dd}")
        launches[route] = launches.get(route, 0) + 1
        fx[key] = (q, k, v)
    if launches != {"flash_attention_wgmma": 2,
                    "flash_attention_wgmma_f32": 2}:
        fail(f"flash_attention path routes {launches}")
    # B2f: the paper's scalar products through the entry points that reach
    # the flat reduction: ops.kahan_dot / kahan_sum / naive_dot and the
    # blocked shims, on 2^24 f32 pairs, one kernel launch each
    launches["fused_reduce"], fx["flat_err"] = phase_flat_path(dev, g)
    # B5: the down projection of a 2048-token prompt (route T) and of a
    # decode batch of 8 (route S), f32 and bf16
    params = api.init_params(qwen, device=dev, seed=SEED)
    w_down = params["layers"][0]["ffn"]["w_down"]
    w_gu = params["layers"][0]["ffn"]["w_gate_up"]
    for m, name in ((2048, "kahan_matmul"), (8, "kahan_matmul_split")):
        a = _randn(g, (m, qwen.d_ff), dev)
        pairs = [(a, w_down),
                 (a.to(torch.bfloat16), w_down.to(torch.bfloat16))]
        outs = _counted(f"kahan_matmul {list(a.shape)} x "
                        f"{list(w_down.shape)} f32 and bf16 (bk 256)",
                        lambda: [K.kahan_matmul(x, w, block_k=256)
                                 for x, w in pairs], {name: 2})
        for (x, w), o in zip(pairs, outs):
            want = kahan_matmul_plain(x, w, block_k=256)
            err = float((o - want).abs().max())
            tol = 1e-5 * x.shape[1] ** 0.5
            log(f"[path] {name} {x.dtype} M={m}: max|kernel-plain| "
                f"{err:.3g} (tol {tol:.3g} + 1e-5 rel)")
            if not torch.isfinite(o).all() or \
                    bool(((o - want).abs() > tol + 1e-5 * want.abs()).any()):
                fail(f"{name} path {x.dtype}")
        launches[name] = 2
        fx["matmul" if m > 8 else "matmul_m8"] = pairs
    # B6: int8 and fp8 weights of the MLP at a decode batch (route S) and
    # a prompt (route T)
    calls = []
    for fmt in (qcore.INT8, qcore.FP8):
        for w in (w_gu, w_down):
            qw, s = qcore.quantize_weight(w, fmt, block_k=256)
            for m in (8, 2048):
                calls.append((fmt.name, _randn(g, (m, w.shape[0]), dev), qw,
                              s))
    want_q8 = {"kahan_matmul_q8": 4, "kahan_matmul_q8_split": 4}
    outs = _counted(f"q8_matmul int8 + fp8 x {list(w_gu.shape)}, "
                    f"{list(w_down.shape)} x M in {{8, 2048}}",
                    lambda: [ops.q8_matmul(x, qw, s) for _, x, qw, s in calls],
                    want_q8)
    for (name, x, qw, s), o in zip(calls, outs):
        want = kahan_matmul_q8_plain(x, qw, s)
        err = (o - want).abs()
        atol = 1e-4 * (qw.shape[0] / 512) ** 0.5
        if not torch.isfinite(o).all() or \
                bool((err > atol + 1e-5 * want.abs()).any()):
            fail(f"q8_matmul path {name} {tuple(x.shape)}x{tuple(qw.shape)}")
    log(f"[path] q8_matmul: {len(calls)} calls finite and within 1e-4 "
        f"sqrt(K/512) + 1e-5 rel of the twin")
    launches.update(want_q8)
    fx["q8"] = calls
    # B7: G = 4 seeded f32 microbatch gradients accumulated into every
    # leaf of the parameter tree, held bitwise to KahanState.add
    leaves = kahan.tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    kern = kahan.KahanState.zeros_like(params)
    plain = kahan.KahanState.zeros_like(params)
    microbatches = 4
    for mb in range(microbatches):
        gg = torch.Generator(device=dev).manual_seed(SEED + 100 + mb)
        upd = kahan.tree_map(lambda t: torch.randn(t.shape, generator=gg,
                                                   device=dev) * 1e-2, params)
        _counted(f"kahan_accumulate microbatch {mb}: {len(leaves)} leaves, "
                 f"{n} f32 elements",
                 lambda: kahan.tree_map(ops.kahan_accumulate, kern.sum,
                                        kern.carry, upd),
                 {"kahan_acc": len(leaves)})
        plain = plain.add(upd)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(
        kahan.tree_leaves((kern.sum, kern.carry)),
        kahan.tree_leaves((plain.sum, plain.carry))))
    log(f"[path] kahan_accumulate: {microbatches} microbatches x "
        f"{len(leaves)} leaves ({n} f32 elements, untied embeddings) "
        f"bitwise KahanState.add: {same}")
    if not same:
        fail("kahan_accumulate path differs from KahanState.add")
    launches["kahan_acc"] = microbatches * len(leaves)
    fx["acc"] = (kern, upd, n, len(leaves))
    return launches, fx


def phase_flat_path(dev, g) -> tuple[int, float]:
    """The flat reduction's entry points on 2^24 f32 pairs (as (2^17, 128)
    blocks for the shims), counted, each held against its plain twin run
    on the same card tensors in the schedule the entry point asks for
    (``unroll`` / ``block_rows`` as the shim or wrapper resolves them) and
    against the fp64 sum of its f32 terms (the products rounded to f32,
    as the twin and the reference round them before they sum, so
    compensation does not cover that rounding):

    * compensated: kernel and twin each within 2 ulp + 8 eps^2 sum|terms|
      of the fp64 sum, and the kernel within that of the twin;
    * naive: the kernel within 16x the twin's own measured gap to the
      fp64 sum, the largest over three summation orders of the twin (the
      entry point's blocks, a quarter and four times them), so one order
      that lands near the exact sum by chance does not set the bound.

    Returns the launches and the largest |kernel - twin|."""
    import torch
    from repro_torch.kernels import engine, ops
    from repro_torch.kernels.kahan_dot import kahan_dot_blocked
    from repro_torch.kernels.kahan_sum import kahan_sum_blocked
    from repro_torch.kernels.naive_dot import naive_dot_blocked
    eps = 2.0 ** -24
    n = 1 << 24
    x = _randn(g, (n,), dev)
    y = _randn(g, (n,), dev)
    x2, y2 = x.view(-1, 128), y.view(-1, 128)
    calls = {"ops.kahan_dot": lambda: ops.kahan_dot(x, y),
             "ops.kahan_sum": lambda: ops.kahan_sum(x),
             "ops.naive_dot": lambda: ops.naive_dot(x, y),
             "kahan_dot_blocked": lambda: kahan_dot_blocked(x2, y2),
             "kahan_sum_blocked": lambda: kahan_sum_blocked(x2),
             "naive_dot_blocked": lambda: naive_dot_blocked(x2, y2)}
    # (operands, output, unroll, block_rows, compensated) as each entry
    # point passes them to the engine
    spec = {"ops.kahan_dot": ((x, y), "dot", None, None, True),
            "ops.kahan_sum": ((x,), "sum", None, None, True),
            "ops.naive_dot": ((x, y), "dot", None, None, False),
            "kahan_dot_blocked": ((x, y), "dot", None, 256, True),
            "kahan_sum_blocked": ((x,), "sum", None, 512, True),
            "naive_dot_blocked": ((x, y), "dot", 1, 256, False)}
    got = _counted(f"the flat reduction's entry points on {n} f32 pairs",
                   lambda: {k: float(f()) for k, f in calls.items()},
                   {"fused_reduce": len(calls)})

    def twin(what, blocks=1.0):
        ops_, o, u, rows, comp = spec[what]
        (out,) = engine.fused_reduce_flat_plain(
            ops_, outputs=(o,), unroll=u, compensated=comp,
            block_elems=int(engine.block_elems_for(n, u, rows) * blocks))
        return float(out)

    xy = (x * y).double()
    exact_dot, exact_sum = float(xy.sum()), float(x.double().sum())
    worst, plain = 0.0, {}
    for what, v in got.items():
        dot = spec[what][1] == "dot"
        exact = exact_dot if dot else exact_sum
        terms = float((xy if dot else x.double()).abs().sum())
        p = plain[what] = twin(what)
        worst = max(worst, abs(v - p))
        if spec[what][4]:
            tol = 2 * eps * 2 * abs(exact) + 8 * eps ** 2 * terms
            ok = max(abs(v - exact), abs(p - exact), abs(v - p)) <= tol
            why = "2 ulp + 8 eps^2 sum|terms|"
        else:
            gap = max(abs(t - exact) for t in (p, twin(what, 0.25),
                                               twin(what, 4.0)))
            tol = 16 * gap
            ok = abs(v - exact) <= tol
            why = f"16x the naive twin's largest gap {gap:.3g} over 3 orders"
        log(f"[path] {what}: |kernel-fp64| {abs(v - exact):.3g}, "
            f"|twin-fp64| {abs(p - exact):.3g}, |kernel-twin| "
            f"{abs(v - p):.3g} (tol {why} = {tol:.3g}): {ok}")
        if not ok:
            fail(f"{what} on the card")
    # what the f32 rounding of the products costs, which compensation
    # does not cover: the compensated twin against the exact products
    p = plain["ops.kahan_dot"]
    exact64 = float((x.double() * y.double()).sum())
    log(f"[path] the f32 products' own rounding: |kahan twin - fp64 sum of "
        f"exact products| {abs(p - exact64):.3g}, against the fp64 sum of "
        f"the f32 products {abs(p - exact_dot):.3g}")
    return len(calls), worst


def phase_slice_times(dev, fx) -> dict:
    """B4-B7 timed at the path's shapes, as ``phase_times`` times B1-B3."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import kahan
    from repro_torch.kernels import kahan_acc as ka
    from repro_torch.quant import core as qcore
    fa, km = _module("flash_attention"), _module("kahan_matmul")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    out = {}

    def row(*a, **kw):
        return time_row(flush, *a, **kw)

    # B4 on its two routes at the path's shapes, D = 64 and a head dim of
    # 40 (padded to a 64-wide panel): bf16 bound by its tensor-core
    # products, f32 by its six bf16 passes; SDPA on the same inputs
    for key, io, dname in (("flash", torch.bfloat16, "bf16"),
                           ("flash_f32", torch.float32, "f32")):
        name = ("flash_attention_wgmma" if io == torch.bfloat16
                else "flash_attention_wgmma_f32")
        for suffix in ("", "_40"):
            q, k, v = fx[key + suffix]
            bh, l, d = q.shape
            q4, k4, v4 = (t.view(4, bh // 4, l, d) for t in (q, k, v))
            passes = 1 if io == torch.bfloat16 else 6
            r = row(
                name, lambda q=q, k=k, v=v: fa.flash_attention_cuda(q, k, v),
                lambda q=q, k=k, v=v: fa.flash_attention_plain(q, k, v),
                lambda q4=q4, k4=k4, v4=v4: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True),
                (name + "_kernel",), fa.bytes_moved(q, k, v),
                passes * fa.flops(bh, l, l, d, d, True), 0, BF16_FLOPS_PER_S,
                f"[{bh}, {l}, {d}] {dname} causal, tensor cores"
                f"{', six bf16 passes' if passes > 1 else ''} (library: SDPA "
                f"is_causal {dname})")
            if suffix:
                out[name]["head_dim_40"] = r
            else:
                out[name] = r
    # B5 and B6 on their routes: T (wgmma) bound by P bf16 passes at the
    # tensor-core rate plus the fold at the f32 rate, S (split + fold)
    # by the bytes or the f32 CUDA-core products
    tile_k = ("kahan_matmul_tile_kernel",)
    split_k = ("kahan_matmul_split_kernel", "kahan_matmul_fold_kernel")

    def mm_row(name, x, w, s=None, what=""):
        m, kk = x.shape
        n = w.shape[1]
        q8 = s is not None
        bk = kk // s.shape[0] if q8 else 256
        mm, fold = km.flops(m, n, kk, bk, scaled=q8)
        split = km.pick_route(m) == "split"
        if split:
            flops, rate, route_txt = mm, F32_FLOPS_PER_S, "route S"
        else:
            p = km.tensor_passes(x.dtype, w.dtype)
            flops, rate = p * mm, BF16_FLOPS_PER_S
            route_txt = f"route T, {p} bf16 pass{'es' if p > 1 else ''}"
        if q8:
            w_deq = qcore.dequantize_weight(w, s)
            run = lambda: km.kahan_matmul_q8_cuda(x, w, s)  # noqa: E731
            plain = lambda: km.kahan_matmul_q8_plain(x, w, s)  # noqa: E731
            lib = lambda: torch.matmul(x, w_deq)  # noqa: E731
            nbytes = km.bytes_moved(x, w, s, out_elems=m * n)
        else:
            run = lambda: km.kahan_matmul_cuda(x, w)  # noqa: E731
            plain = lambda: km.kahan_matmul_plain(x, w)  # noqa: E731
            lib = lambda: torch.matmul(x, w)  # noqa: E731
            nbytes = km.bytes_moved(x, w, out_elems=m * n)
        return row(name, run, plain, lib, split_k if split else tile_k,
                   nbytes, flops, fold, rate,
                   f"{what} [{m}, {kk}] x [{kk}, {n}] bk {bk}, {route_txt}")

    (a, w), (ab, wb) = fx["matmul"]
    out["kahan_matmul"] = mm_row(
        "kahan_matmul", a, w,
        what="f32 (library: torch.matmul f32, TF32 off)")
    out["kahan_matmul"]["bf16"] = mm_row(
        "kahan_matmul", ab, wb, what="bf16 (library: torch.matmul bf16)")
    (a, w), (ab, wb) = fx["matmul_m8"]
    out["kahan_matmul_split"] = mm_row(
        "kahan_matmul_split", a, w,
        what="f32 (library: torch.matmul f32, TF32 off)")
    out["kahan_matmul_split"]["bf16"] = mm_row(
        "kahan_matmul_split", ab, wb, what="bf16 (library: torch.matmul bf16)")
    picks = {}
    for name, x, qw, s in fx["q8"]:
        if qw.shape[1] < qw.shape[0]:                 # the down projection
            picks[(name, x.shape[0])] = (x, qw, s)
    lib_q8 = "(library: torch.matmul f32 against the weight dequantized once)"
    for key in (("int8", 2048), ("fp8", 2048), ("int8", 8), ("fp8", 8)):
        x, qw, s = picks[key]
        name = "kahan_matmul_q8" + ("_split" if key[1] == 8 else "")
        r = mm_row(name, x, qw, s, what=f"{key[0]} {lib_q8}")
        if key[0] == "int8":
            out[name] = r
        else:
            out[name][key[0]] = r
    kern, upd, n, nleaves = fx["acc"]
    trip = list(zip(kahan.tree_leaves(kern.sum), kahan.tree_leaves(kern.carry),
                    kahan.tree_leaves(upd)))
    out["kahan_acc"] = row(
        "kahan_acc", lambda: [ka.kahan_acc_flat_cuda(s, c, u)
                              for s, c, u in trip],
        lambda: [ka.kahan_acc_flat_plain(s, c, u) for s, c, u in trip],
        lambda: [s.add_(u) for s, _, u in trip], ("kahan_acc_kernel",),
        ka.bytes_moved(n), 8 * n, 0, F32_FLOPS_PER_S,
        f"one microbatch into the whole qwen1.5-0.5b tree ({nleaves} "
        f"launches, {n} f32 elements; library: naive sum.add_(u), 12 B per "
        f"element, the paper's baseline)")
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
        f"call is one kernel launch); guard trips {st['guard_trips']}")
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
    launched per step, and the kernels that take the most device time.

    The tracer now and then loses device events (``kernel_ms``), which
    would read low here. So a window counts only when it holds exactly
    ``n_steps`` x the layers' launches of the paged-attention kernels (one
    split and one merge per layer and step: B1's for a GQA model, B3's for
    MLA, whose split and merge run once per chunk of the table's
    partitions); otherwise the window is traced again with fresh requests
    after 0.5 s, ``PROFILE_TRIES`` times at most, and then the phase
    fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import Request
    names = LATENT_KERNELS if cfg.mla is not None else PAGED_KERNELS
    want = n_steps * cfg.num_layers
    if cfg.mla is not None:
        lib = pa._latent_lib()
        want *= -(-engine.layout.max_blocks
                  // (lib.repro_paged_latent_attention_slots()
                      * lib.repro_paged_latent_attention_chunk()))
    g = torch.Generator().manual_seed(SEED + 1)
    lost = 0
    for attempt in range(PROFILE_TRIES):
        for i in range(engine.max_slots):
            prompt = torch.randint(0, cfg.vocab_size, (256,), generator=g)
            engine.submit(Request(rid=100 + engine.max_slots * attempt + i,
                                  prompt=prompt.tolist(),
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
        engine.run_until_done()
        kern = _device_kernels(prof)
        counts = {n: sum(ev.count for ev in kern if n in ev.key)
                  for n in names}
        reduce_n = sum(ev.count for ev in kern
                       if "fused_reduce_kernel" in ev.key)
        if all(c == want for c in counts.values()) and \
                reduce_n == 2 * n_steps:
            break
        lost += 1
        log(f"[profile] {cfg.name} decode window, try {attempt + 1}: the "
            f"profiler lost device events ({counts}, want {want} each; "
            f"fused_reduce_kernel {reduce_n}, want {2 * n_steps}); tracing "
            f"again")
        time.sleep(0.5)
    else:
        fail(f"{cfg.name}: every decode window lost device events")
    busy_ms = sum(_device_us(ev) for ev in kern) / 1e3 / n_steps
    per_step = sum(ev.count for ev in kern) / n_steps
    log(f"[profile] {cfg.name} decode window, {n_steps} steps x 8 slots: wall "
        f"{wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step, "
        f"device idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{per_step:.0f} kernels/step; launches of {', '.join(names)}: "
        f"{counts} (want {want} each), of fused_reduce_kernel {reduce_n} "
        f"(two calls per step, one kernel each); windows lost to the "
        f"profiler: {lost}")
    label = "MLA latent attention" if cfg.mla is not None else \
        "GQA attention"
    mine = [ev for ev in kern if any(n in ev.key for n in names)]
    log(f"[profile] {label} (split + merge): "
        f"{sum(_device_us(ev) for ev in mine) / 1e3 / n_steps:.4f} "
        f"ms/step of device time, "
        f"{sum(ev.count for ev in mine) / n_steps:.1f} kernel "
        f"launches/step")
    for ev in sorted(kern, key=_device_us, reverse=True)[:10]:
        log(f"[profile]   {_device_us(ev) / 1e3 / n_steps:8.3f} ms/step "
            f"{ev.count / n_steps:6.1f}/step  {ev.key[:90]}")


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
    acc_err = phase_acc_parity(dev)
    mm_err = phase_matmul_parity(dev)
    flash_err = phase_flash_parity(dev)
    qwen = get_config("qwen1.5-0.5b")
    k_launch, fx = phase_kernel_path(dev, qwen)
    times = phase_times(dev)
    times.update(phase_slice_times(dev, fx))
    flat_err = fx["flat_err"]
    log(f"[times] profiler tries that lost device events (profiled again): "
        f"{len(DROPPED_WINDOWS)} {DROPPED_WINDOWS}; rows timed by CUDA "
        f"events instead: {len(EVENT_TIMED)} {EVENT_TIMED}")
    del fx
    torch.cuda.empty_cache()
    for arch in SMALL_ARCHS:
        phase_small(dev, arch)
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
             launches=q_launch["fused_reduce"] + d_launch["fused_reduce"]
             + k_launch["fused_reduce"],
             launches_by_path={"qwen1.5-0.5b": q_launch["fused_reduce"],
                               "deepseek-v2-236b": d_launch["fused_reduce"],
                               "flat entry points": k_launch["fused_reduce"]},
             max_abs_err=red_err, **times["fused_reduce"],
             flat=dict(replaces="src/repro/kernels/engine.py:282",
                       max_abs_err=flat_err, **times["fused_reduce_flat"])),
        dict(name="paged_latent_attention", route="cuda",
             source="src/repro_torch/csrc/paged_latent_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:354",
             launches=d_launch["paged_latent_attention"],
             max_abs_err=lat_err, **times["paged_latent_attention"]),
        *(dict(name=name, route="cuda",
               source="src/repro_torch/csrc/flash_attention_wgmma.cu",
               replaces="src/repro/kernels/flash_attention.py:144",
               launches=k_launch[name], max_abs_err=flash_err[name],
               **times[name])
          for name in ("flash_attention_wgmma", "flash_attention_wgmma_f32")),
        *(dict(name=name, route="cuda",
               source="src/repro_torch/csrc/kahan_matmul.cu",
               replaces="src/repro/kernels/kahan_matmul.py:"
                        + ("125" if "q8" in name else "61"),
               launches=k_launch[name], max_abs_err=mm_err[name],
               **times[name])
          for name in ("kahan_matmul", "kahan_matmul_split",
                       "kahan_matmul_q8", "kahan_matmul_q8_split")),
        dict(name="kahan_acc", route="cuda",
             source="src/repro_torch/csrc/kahan_acc.cu",
             replaces="src/repro/kernels/kahan_acc.py:45",
             launches=k_launch["kahan_acc"], max_abs_err=acc_err,
             **times["kahan_acc"]),
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
