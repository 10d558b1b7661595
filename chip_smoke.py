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
             a fused_reduce call that launches more than one kernel; the
             verify window's rows: B1 and B3 at B = 8, W = 5, B2 at
             [40, 151936];
6. small   — reduced qwen1.5 and reduced deepseek-v2 served on the card
             and on the CPU (plain twins) from the same weights: logits
             agree;
7. verify  — the speculative verify window (``verify_fn``) for 8 slots x
             5 tokens against 5 sequential ``decode_fn`` steps on a copy
             of the cache: full-width qwen1.5-0.5b over bf16, int8 and
             fp8 pools and the 3-layer deepseek-v2-236b (MoE tokens routed
             differently in the window are left out and printed); prints
             the formulation noise N (max |logit difference|), holds the
             argmax, the written entries (one storage step), ``len``
             before and after ``set_lens`` and one attention launch per
             layer;
8. serve   — the main paths, each with its launch counters zeroed just
             before and read just after: full-width qwen1.5-0.5b (24
             layers) behind ``DecodeEngine`` over bf16, int8 and fp8
             pools, then behind ``SpecDecodeEngine`` with an n-gram
             proposer (spec_k 4) and a self-draft (``DraftModelProposer``
             on the same weights, spec_k 3), whose streams must equal the
             bf16 ``DecodeEngine`` streams but past a printed near-tie
             (a verify row's top-2 gap within 4 N); full-width
             deepseek-v2-236b cut to 3 layers (1 dense + 2 MoE; MLA latent
             pools) behind ``DecodeEngine`` and ``SpecDecodeEngine``
             (n-gram, spec_k 4). Random seeded weights, 8 slots, 16
             requests of 64-512 prompt tokens, 32 new tokens each; the
             counters must match the decode, verify and draft steps;
             every non-spec path and the n-gram qwen path end in a
             profiled window of 4 steps, used only when it holds every
             paged-attention launch it should and one fused_reduce kernel
             per reduction call;
9. rng     — ``core/prng.py`` on the card against the CPU, bitwise (bits
             over 2^20 counters for 64 keys, ``fold_in`` chains,
             ``uniform``, ``randint``), jax 0.9.0's known answers on both,
             and gumbel noise card vs CPU (max distance printed);
10. sample — ``_sample_rows`` on 8 logit rows of width 151936, card vs
             CPU at top_k 0, 50 and 1 (equal tokens but printed
             near-ties), and a Monte-Carlo check of 2^16 keyed draws
             against ``target_dist`` (total variation < 0.02);
11. sampled serve — qwen1.5-0.5b behind ``DecodeEngine`` with 8
             requests at temperature 0.8 / top_k 50, 4 at 1.0, 2 at
             top_k 1 and 2 greedy: greedy and top_k 1 streams bitwise the
             bf16 phase's, a reverse-order run bitwise, counters equal
             to the calls, a profiled window of sampled decode steps;
             then behind ``SpecDecodeEngine`` (n-gram spec_k 4,
             self-draft spec_k 3) with every request sampled, each run
             twice and bitwise the same, with the host time of
             ``rejection_sample`` and of drafting per step;
12. faults — a ``FailoverServer`` over a bf16 ``DecodeEngine`` with
             ``alloc_fail``, ``kv_corrupt`` and ``logit_nan`` at fixed
             steps, a deadline and a cancellation, run twice with one
             seed (the same firings; guard-tripped requests finish on the
             degraded engine with the bf16 streams; nothing held at the
             end), and a ``SpecDecodeEngine`` with ``proposer_stall``;
13. prefix — a warm-up request with a 256-token system prompt, then 16
             requests of it + 32-224 tokens on a prefix-caching engine
             and on a cold one: every request hits 256 tokens (a chunk
             boundary), tokens and logprobs bitwise; a copy-on-write hit
             under the near-tie rule; int8 / fp8 hit pairs, bitwise;
14. session — 8 conversations x 3 turns, warm, then replayed cold: hits
             per turn, streams under the near-tie rule, logprobs before
             parting and decode-written vs prefill-written entries (in
             storage steps) each within a fixed limit of sound runs
             (``tools/session_noise.py``);
15. preempt — the serve phases' 16 requests on half the blocks with
             ``preempt="lru"`` over bf16, int8 and fp8: streams bitwise
             the serve phases'; snapshot and pinned host-link copy rates;
16. spill  — prefix cache + session KV + ``spill_blocks`` under pool
             pressure, run with ``promote="auto"`` (the H100 gate, ratio
             printed; below 1 for qwen1.5-0.5b with bf16 tensor-core
             re-prefill, so nothing may be promoted) and with
             ``promote="always"`` (blocks promoted, each bitwise its
             snapshot); nothing held at the end. Counters on every run of
             13-17;
17. obs    — the bf16 serve phase's 16 requests under
             ``Telemetry(wall_clock=True, profile=True)``, twice, and
             without telemetry: tokens and logprobs bitwise the serve
             phase's, trace key sequences equal and spans balanced,
             ``metrics_snapshot`` holding every ``kv_stats`` counter, the
             launch counters the serve phase's; prints the profiler's
             B2f calibration, the per-phase ECM attribution, the residual
             rows and the median step with telemetry on and off; the
             deepseek-v2 and qwen1.5 decode numbers of the bf16 weight
             repair (``[c1]``) after the deepseek-v2 phases.

The last two lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``. Imports nothing of ``jax`` or of the
reference package ``repro``.
"""

from __future__ import annotations

import collections
import json
import math
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
# 8-slot decode step, a request's first token and a verify step (8 slots
# x (k + 1) = 5 window positions), at qwen1.5's and deepseek-v2's vocab
# widths. The split geometry follows N alone: 151936 gives 38 splits of
# 4096 with a ragged last one, 102400 gives 25 of 4096 and no tail.
REDUCE_SHAPES = ((8, 151936), (1, 151936), (8, 102400), (1, 102400),
                 (40, 151936), (40, 102400))


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
    out.update(verify_times(dev, flush))
    return out


def _window_mask(lens, w: int, length: int):
    """[B, 1, W, L] bool: query row j of a sequence sees the keys below
    lens - W + j + 1 (the window was just appended)."""
    import torch
    kpos = torch.arange(length, device=lens.device)
    lim = (lens[:, None] - w + 1
           + torch.arange(w, device=lens.device)[None, :])      # [B, W]
    return (kpos[None, None, :] < lim[:, :, None])[:, None]


def verify_times(dev, flush) -> dict:
    """The three kernels of the verify window at its shapes: B1 and B3 at
    B = 8 slots, W = k + 1 = 5 rows each (the decode rows' tables and
    lengths, the window the last 5 positions), and B2 over the window's
    [8 x 5, 151936] logits. Libraries: SDPA on the gathered rows with the
    window's causal mask (B3's in f32); none for B2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import engine
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import paged
    w = VERIFY_K + 1
    lens = [544, 65, 300, 400, 97, 512, 130, 256]
    out = {}
    x = attention_case(dev, mb=64, w=w, lens=lens)
    args = (x["q"], x["kpool"], x["vpool"], x["block_table"], x["lens"],
            x["q_offsets"])
    kg = paged.gather_blocks(x["kpool"], x["block_table"]).transpose(1, 2)
    vg = paged.gather_blocks(x["vpool"], x["block_table"]).transpose(1, 2)
    mask = _window_mask(x["lens"], w, kg.shape[2])
    qs = x["q"].transpose(1, 2)
    keys = int(mask.sum())                  # (row, key) pairs the data needs
    out["paged_attention_verify"] = time_row(
        flush, "paged_attention W=5", lambda: pa.paged_attention_cuda(*args),
        lambda: pa.paged_attention_plain(*args),
        lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask),
        PAGED_KERNELS,
        pa.bytes_moved(x["q"], x["kpool"], x["vpool"], x["block_table"],
                       x["lens"]),
        0, 4 * keys * x["q"].shape[2] * x["q"].shape[3], F32_FLOPS_PER_S,
        f"B=8 W={w} Hq=Hkv=16 D=64 bs=16 tokens={int(x['lens'].sum())} "
        f"bf16 pools, the verify window (library: SDPA on gathered rows, "
        f"window-causal mask)", plain_reps=5)
    x = latent_case(dev, mb=64, w=w, lens=lens)
    largs, kw = _latent_args(x)
    ckg = paged.gather_blocks(x["ck_pool"], x["block_table"]).float()
    krg = paged.gather_blocks(x["kr_pool"], x["block_table"]).float()
    h = x["q_lat"].shape[2]
    kq = torch.cat([ckg, krg], dim=-1)[:, None].expand(-1, h, -1, -1)
    vq = ckg[:, None].expand(-1, h, -1, -1)
    qq = torch.cat([x["q_lat"], x["q_rope"].float()], dim=-1).transpose(1, 2)
    lmask = _window_mask(x["lens"], w, ckg.shape[1])
    out["paged_latent_attention_verify"] = time_row(
        flush, "paged_latent_attention W=5",
        lambda: pa.paged_latent_attention_cuda(*largs, **kw),
        lambda: pa.paged_latent_attention_plain(*largs, **kw),
        lambda: F.scaled_dot_product_attention(qq, kq, vq, attn_mask=lmask,
                                               scale=x["scale"]),
        LATENT_KERNELS,
        pa.latent_bytes_moved(x["q_lat"], x["q_rope"], x["ck_pool"],
                              x["kr_pool"], x["block_table"], x["lens"]),
        pa.latent_tensor_flops(x["q_lat"], x["q_rope"], x["ck_pool"],
                               x["q_offsets"]), 0, BF16_FLOPS_PER_S,
        f"B=8 W={w} H=128 C=512 R=64 bs=16 tokens={int(x['lens'].sum())}, "
        f"the verify window, bf16 tensor-core passes (library: SDPA on "
        f"gathered rows, f32, window-causal mask)", plain_reps=2)
    g = torch.Generator(device=dev).manual_seed(5)
    rows = 8 * w
    lg = torch.randn((rows, 151936), generator=g, device=dev)
    outs = ("max", "sum", "sumsq")
    out["fused_reduce_verify"] = time_row(
        flush, "fused_reduce [40,151936]",
        lambda: engine.fused_reduce_rows_cuda((lg,), outputs=outs),
        lambda: engine.fused_reduce_rows_plain((lg,), outputs=outs), None,
        ("fused_reduce_kernel",),
        engine.bytes_moved(rows, 151936, 1, len(outs)), 0,
        rows * 151936 * (6 + 1 + 6 + 1), F32_FLOPS_PER_S,
        f"[{rows},151936] (max,sum,sumsq), a verify step's first call, one "
        f"launch (library: none, no single PyTorch call computes the "
        f"compensated fused statistics)", plain_reps=3)
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
    # decode batch of 8 (route S), f32 and bf16; the tree stays f32 (a
    # training master copy: B7 accumulates into every leaf of it)
    params = api.init_params(qwen, device=dev, seed=SEED, hold_bf16=False)
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


# the verify window: spec_k of the verify parity and n-gram phases (windows
# of k + 1 = 5 rows per slot), and of the self-draft phase
VERIFY_K = 4
DRAFT_K = 3
STORAGE_STEP = {"bf16": 2.0 ** -7, "int8": 1 / 127, "fp8": 1 / 8}
SCALE_OF = {"kpool": "kscale", "vpool": "vscale", "c_kv": "c_kv_scale",
            "k_rope": "k_rope_scale"}


def phase_verify_parity(dev, cfg, params, label: str) -> float:
    """The verify window against the decode steps it replaces, on the
    card. 8 prompts of 17-480 tokens are prefilled; then, on copies of
    that cache:

    * control: a 1-token window through ``verify_fn`` against one
      ``decode_fn`` step. Same rows, same GEMM shapes (M = 8), the
      superkernel at width 1 both ways: logits and written entries must
      be bitwise equal;
    * the window: 5 tokens per slot (the decode steps' greedy stream)
      through ``verify_fn`` against 5 decode steps. Its GEMMs run at
      M = 40 rows and cuBLAS picks its kernels by M, so they sum in
      another order; N, the max |logit difference|, is that formulation
      noise after it has travelled through the model;
    * the same 5 decode steps at 40 slots (slots 8-39 idle): decode
      with the window's GEMM rows, M = 40. The window must be these
      steps bitwise, logits and written entries: so N is the distance
      between decode at M = 40 and at M = 8 (printed), the GEMMs'
      dependence on M that the model's depth amplifies.

    Fails unless: the control is bitwise; the window is the M = 40
    decode steps bitwise; the window's argmax is equal
    at every position, or differs only at a near-tie, printed (a decode
    row whose top-2 gap is within 4x the median row deviation; a
    differing argmax always has a gap within 2x its own row's deviation,
    so the median keeps the rule from holding by construction); layer
    0's written entries, whose inputs are the same tokens, are within
    one storage step of the decode steps' (bf16 2^-7, int8 1/127, fp8
    1/8 of the row's largest value: the CPU test's bound; the deeper
    layers' are printed); ``len`` is exact before and after
    ``set_lens``; each window launched the model's attention kernel once
    per layer and nothing else. MoE tokens routed to other experts in
    the window than in decode (capacity and router near-ties depend on
    which tokens share a call) are printed and left out from there on in
    their slot. Returns N."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api, paged
    from repro_torch.quant import core as qcore
    w = VERIFY_K + 1
    lens = [100, 37, 250, 480, 17, 300, 64, 129]
    b = len(lens)
    kv = api.KVCache.build(cfg, max_context=1024, block_size=16, max_slots=b)
    base = kv.init(b, device=dev)
    table = paged.identity_table(b, kv.layout, device=dev)
    g = torch.Generator().manual_seed(SEED + 2)
    for s, n in enumerate(lens):
        paged.reset_slot(base, s, table[s])
        prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=g,
                               dtype=torch.int32).to(dev)
        for p0 in range(0, n, 256):
            api.prefill_chunk_fn(cfg)(params, prompt[:, p0:p0 + 256], base,
                                      s, p0)
    first = torch.randint(0, cfg.vocab_size, (b,), generator=g,
                          dtype=torch.int32).to(dev)
    slots = torch.arange(b, dtype=torch.int32, device=dev)
    pos0s = torch.tensor(lens, dtype=torch.int32, device=dev)
    bs = kv.layout.block_size
    names = ("c_kv", "k_rope") if cfg.mla is not None else ("kpool", "vpool")
    attn = "paged_latent_attention" if cfg.mla is not None \
        else "paged_attention"

    def copy(c):
        return {k: v.clone() for k, v in c.items()}

    def entries(c, name, width):
        """[L, b, width, ...] f32: the entries at pos0..pos0+width-1."""
        pos = pos0s[:, None].long() + torch.arange(width, device=dev)[None]
        blk = torch.gather(c["block_table"][0, :b].long(), 1, pos // bs)
        v = qcore.cast_f32(c[name][:, blk, pos % bs])
        if SCALE_OF[name] in c:
            v = v * c[SCALE_OF[name]][:, blk, pos % bs][..., None]
        return v

    def verify(c, win):
        ops.reset_launches()
        out = api.verify_fn(cfg)(params, win, c, slots, pos0s)
        torch.cuda.synchronize()
        return out, {k: v for k, v in ops.launches.items() if v}

    # control: one token through both paths at M = 8
    cv, cd = copy(base), copy(base)
    one, one_launch = verify(cv, first[:, None].contiguous())
    dec_one = api.decode_fn(cfg)(params, first[:, None], cd)
    control = torch.equal(one[:, 0], dec_one) and all(
        torch.equal(entries(cv, n, 1), entries(cd, n, 1)) for n in names)
    # the window against 5 decode steps
    caches, dec = copy(base), copy(base)
    toks = [first]
    rows = []
    routes = _RouteLog() if cfg.moe is not None else None
    for _ in range(w):
        lg = api.decode_fn(cfg)(params, toks[-1][:, None], dec)
        rows.append(lg)
        toks.append(torch.argmax(lg, dim=-1).to(torch.int32))
    want = torch.stack(rows, 1)                                 # [b, w, V]
    win = torch.stack(toks[:w], 1).contiguous()
    dec_routes = routes.take() if routes is not None else None
    got, launches = verify(caches, win)
    win_routes = routes.take() if routes is not None else None
    # the same decode steps with the window's M = b * w GEMM rows: slots
    # b.. idle on the null block
    m = b * w
    kvm = api.KVCache.build(cfg, max_context=1024, block_size=16,
                            max_slots=m, num_blocks=kv.num_blocks)
    dm = kvm.init(m, device=dev)
    for k, v in base.items():
        if k in ("block_table", "len"):
            dm[k][:, :b] = v
        else:
            dm[k].copy_(v)
    tm = torch.zeros((m, 1), dtype=torch.int32, device=dev)
    rows_m = []
    for j in range(w):
        tm[:b, 0] = toks[j]
        rows_m.append(api.decode_fn(cfg)(params, tm, dm)[:b])
    rows_m = torch.stack(rows_m, 1)
    keep = torch.ones((b, w), dtype=torch.bool, device=dev)
    if routes is not None:
        flipped = routes.compare(dec_routes, win_routes, b, w, cfg.moe) | \
            routes.compare(routes.take(), win_routes, b, w, cfg.moe)
        keep = torch.cumsum(flipped.to(torch.int32), dim=1) == 0
        routes.close()
        log(f"[verify] {label} {cfg.kv_dtype} pools: tokens routed to other "
            f"experts in the window than in decode (M = {b} or {m}): "
            f"{flipped.nonzero().tolist()}; positions left out from there "
            f"on: {int((~keep).sum())} of {b * w}")
    if not bool(keep.any()):
        fail(f"verify {label} {cfg.kv_dtype}: every position was routed "
             f"to other experts than in decode")
    n_dec = float((rows_m - want).abs().amax(dim=-1)[keep].max())
    same = torch.equal(rows_m[keep], got[keep]) and all(
        torch.equal(entries(dm, n, w)[:, keep],
                    entries(caches, n, w)[:, keep]) for n in names)
    row_dev = (got - want).abs().amax(dim=-1)[keep]
    noise = float(row_dev.max())
    typical = float(row_dev.median())
    top2 = torch.topk(want, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = ((got.argmax(-1) != want.argmax(-1)) & keep).nonzero().tolist()
    ties = [(i, j, float(gap[i, j])) for i, j in differ]
    step = STORAGE_STEP[cfg.kv_dtype]
    per_layer = torch.zeros(cfg.num_layers, device=dev)
    for name in names:
        a, e = entries(caches, name, w)[:, keep], entries(dec, name, w)[:, keep]
        amax = e.abs().amax(dim=-1, keepdim=True)
        dev_steps = ((a - e).abs() / (step * amax + 1e-6))
        per_layer = torch.maximum(per_layer, dev_steps.flatten(1).amax(1))
    per_layer = [round(float(x), 3) for x in per_layer]
    lens_ok = torch.equal(caches["len"], dec["len"])
    new = pos0s + 2                         # as if one draft was accepted
    paged.set_lens(caches, slots, new)
    paged.set_lens(dec, slots, new)
    lens_ok = lens_ok and torch.equal(caches["len"], dec["len"]) and \
        bool((caches["len"] == new[None, :]).all())
    log(f"[verify] {label} {cfg.kv_dtype} pools, 8 slots, contexts "
        f"{min(lens)}-{max(lens)}: control (1-token window vs one decode "
        f"step, M = 8 both) bitwise {control}, launches {one_launch}; "
        f"{w}-token window vs {w} decode steps: N = max|logit diff| "
        f"{noise:.4g} (median row {typical:.4g}); the decode steps at "
        f"M = {m} against M = {b}: max|logit diff| {n_dec:.4g}; the window "
        f"against the decode steps at M = {m}: bitwise (logits and "
        f"entries) {same}; argmax differs "
        f"at {len(ties)} of {int(keep.sum())} positions {ties} (accepted "
        f"only at a decode top-2 gap <= 4x the median row deviation); "
        f"written entries per layer, in storage steps ({step:.4g} x the "
        f"row's max |value|; layer 0 must stay within 1): {per_layer}; "
        f"len exact before and after set_lens {lens_ok}; launches "
        f"{launches}")
    if got.shape != (b, w, cfg.vocab_size) or \
            not bool(torch.isfinite(got).all()):
        fail(f"verify {label} {cfg.kv_dtype}: logits {tuple(got.shape)}, "
             f"finite {bool(torch.isfinite(got).all())}")
    if not control or one_launch != {attn: cfg.num_layers}:
        fail(f"verify {label} {cfg.kv_dtype}: the 1-token window is not "
             f"the decode step bitwise (or launched {one_launch})")
    if not same:
        fail(f"verify {label} {cfg.kv_dtype}: the window is not the decode "
             f"steps at the same M = {m} bitwise")
    if any(t[2] > 4 * typical for t in ties):
        fail(f"verify {label} {cfg.kv_dtype}: an argmax differs past a "
             f"near-tie")
    if per_layer[0] > 1.0 or not lens_ok or \
            launches != {attn: cfg.num_layers}:
        fail(f"verify {label} {cfg.kv_dtype}: layer 0 entries "
             f"{per_layer[0]} steps, len exact {lens_ok}, launches "
             f"{launches}")
    return noise


class _RouteLog:
    """Records the experts ``moe._top_k`` picks, call by call, while it is
    open: the MoE layers of one decode step, or of one verify window."""

    def __init__(self):
        from repro_torch.models import moe
        self._moe, self._top_k = moe, moe._top_k
        self._calls = []

        def recording(probs, k):
            vals, idx = self._top_k(probs, k)
            self._calls.append(idx)
            return vals, idx

        moe._top_k = recording

    def take(self) -> list:
        calls, self._calls = self._calls, []
        return calls

    def close(self) -> None:
        self._moe._top_k = self._top_k

    def kept(self, idx, cfg):
        """[T, k] picks -> the experts each token keeps after capacity
        (``moe.moe_forward``'s stable sort by expert: earlier tokens
        win), dropped picks as -1, sorted."""
        import torch
        t, k = idx.shape
        flat = idx.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        counts = torch.bincount(flat, minlength=cfg.num_experts)
        offsets = torch.cumsum(counts, 0) - counts
        ranks = torch.empty_like(flat)
        ranks[order] = (torch.arange(t * k, device=flat.device)
                        - offsets[flat[order]])
        cap = self._moe.capacity(t, cfg)
        return torch.where(ranks < cap, flat, -1).reshape(t, k) \
            .sort(dim=-1).values

    def compare(self, dec: list, win: list, b: int, w: int, cfg):
        """[b, w] bool: token (slot, position) kept other experts in a MoE
        layer of the window than in its decode step. ``dec`` holds w steps
        x m layers of picks whose first b rows are the slots (idle rows
        after them), ``win`` m layers of [b * w, k]."""
        import torch
        m = len(win)
        flipped = torch.zeros((b, w), dtype=torch.bool,
                              device=win[0].device)
        for layer in range(m):
            v = self.kept(win[layer], cfg).reshape(b, w, -1)
            for j in range(w):
                flipped[:, j] |= (self.kept(dec[j * m + layer], cfg)[:b]
                                  != v[:, j]).any(dim=-1)
        return flipped


def serve_run(engine, reqs) -> tuple[float, list, dict]:
    """Submit ``reqs``, zero the launch counters, run ``engine`` until
    every request finishes and read the counters. Returns the wall time
    (s), the host-clock time of each decode (or verify) step (ms; a step
    ends in its one host transfer) and the counters."""
    import torch
    from repro_torch.kernels import ops
    step_ms = []
    decode_step = engine._decode_step

    def timed_decode_step():
        t = time.perf_counter()
        decode_step()
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
    return wall, step_ms, launches


def check_served(what: str, engine, reqs, launches: dict, want: dict,
                 new_tokens: int = 32) -> None:
    """Every request done with its full output, no guard trip, finite
    statistics, and the launch counters equal to the calls the path
    makes."""
    import torch
    if not all(r.done and len(r.output) == new_tokens for r in reqs):
        fail(f"{what}: a request did not finish with its full output")
    if engine.kv_stats["guard_trips"] or engine.quarantined:
        fail(f"{what}: the numerics guard tripped (non-finite or round-off "
             f"logits)")
    if not all(bool(torch.isfinite(torch.as_tensor(v)).all())
               for v in engine.last_logit_stats.values()):
        fail(f"{what}: non-finite logit statistics")
    full = dict.fromkeys(launches, 0)
    full.update(want)
    if launches != full:
        fail(f"{what}: launch counters {launches} != {full}")


def phase_serve(dev, kind: str, cfg, what: str, params) -> dict:
    """One main path: ``cfg`` behind ``DecodeEngine`` on the card. The
    launch counters are zeroed just before the 16 requests run and read
    just after; each decode step must have launched the model's attention
    kernel once per layer and the reduction twice, plus twice per
    request's first token."""
    import torch
    from repro_torch.serving.engine import DecodeEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = DecodeEngine(cfg, params, max_slots=8, max_context=1024,
                          block_size=16, prefill_chunk=256, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = make_requests(cfg)
    wall, step_ms, launches = serve_run(engine, reqs)
    step_med = statistics.median(step_ms)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    st = engine.kv_stats
    emitted = sum(len(r.output) for r in reqs)
    log(f"[serve] {what} {cfg.kv_dtype} pools on {kind}: 16 requests, "
        f"prompts {min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, {emitted} tokens "
        f"emitted in {wall:.3f} s = {emitted / wall:.2f} tok/s; "
        f"{st['decode_steps']} decode steps, median step "
        f"{step_med:.3f} ms; {st['prefill_chunks']} prefill chunks; "
        f"engine set-up {setup_s:.2f} s; peak device memory {peak_gib:.2f} "
        f"GiB")
    log(f"[serve] launching wrapper calls {launches} (each fused_reduce "
        f"call is one kernel launch); guard trips {st['guard_trips']}")
    attn = "paged_latent_attention" if cfg.mla is not None \
        else "paged_attention"
    check_served(f"{cfg.name} {cfg.kv_dtype} serve", engine, reqs, launches,
                 {attn: cfg.num_layers * st["decode_steps"],
                  "fused_reduce": 2 * (st["decode_steps"] + len(reqs))})
    prof = profile_decode(engine, cfg)
    log(f"[serve] peak device memory with the profiled window "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return dict(launches=launches, tok_s=emitted / wall, step_ms=step_med,
                streams={r.rid: list(r.output) for r in reqs},
                logprobs={r.rid: list(r.logprobs) for r in reqs},
                profile=prof, peak_gib=peak_gib)


class SpecProbe:
    """Beside a ``SpecDecodeEngine`` run, per verify step with greedy
    slots only: the top-2 gap of every window row, and the gap between
    the top logit and the logit of the draft each row judged, mapped to
    (request, output index). Costs a top-2 and a gather over the
    [S, C, V] logits and one small transfer per step (torch ops, no
    counted launch)."""

    def __init__(self, engine):
        import numpy as np
        import torch
        from repro_torch.spec import greedy_verify
        self.engine = engine
        self.gaps: dict = {}            # rid -> {output index: top-2 gap}
        self.rejections: list = []      # (rid, index, draft, target, gap)
        accept = engine._accept_greedy

        def probed_accept(lg, tok, ks):
            decoding = [engine.scheduler.decoding[s]
                        for s in sorted(engine.scheduler.decoding)]
            packed = accept(lg, tok, ks)
            tokens = tok.cpu().numpy()
            top2 = torch.topk(lg, 2, dim=-1).values
            drafted = torch.gather(lg[:, :-1], 2,
                                   tok.long()[:, 1:, None])[..., 0]
            gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()
            dgap = (top2[:, :-1, 0] - drafted).cpu().numpy()
            argmax = packed[0].astype(np.int32).reshape(tokens.shape)
            for i, req in enumerate(decoding):
                acc, emitted = greedy_verify(argmax[i],
                                             tokens[i, 1:1 + ks[i]].tolist())
                base = len(req.output)
                for j in range(len(emitted)):
                    self.gaps.setdefault(req.rid, {})[base + j] = \
                        float(gap[i, j])
                if acc < ks[i]:
                    self.rejections.append(
                        (req.rid, base + acc, int(tokens[i, 1 + acc]),
                         int(argmax[i, acc]), float(dgap[i, acc])))
            return packed

        engine._accept_greedy = probed_accept

    def detach(self) -> None:
        del self.engine._accept_greedy


def check_streams(what: str, reqs, base: dict, probe,
                  noise: float, tag: str = "spec",
                  ref: str = "the non-spec stream") -> int:
    """Each stream equals ``base`` (the non-spec stream by default), or
    first differs at a token whose logit row (a verify row, or with a
    ``GapProbe`` a decode or prefill row) has a top-2 gap within 4 N (a
    near-tie that the formulation noise N may order either way; printed).
    Returns the number of such near-ties."""
    ties = 0
    for r in reqs:
        want = base[r.rid]
        p = next((i for i, (a, b) in enumerate(zip(r.output, want))
                  if a != b), None)
        if p is None:
            if len(r.output) != len(want):
                fail(f"{what}: request {r.rid} emitted {len(r.output)} "
                     f"tokens, {ref} {len(want)}")
            continue
        gap = probe.gaps.get(r.rid, {}).get(p)
        log(f"[{tag}] {what}: request {r.rid} first differs from {ref} at "
            f"token {p} ({r.output[p]} vs {want[p]}); its row's top-2 gap "
            f"there {gap} (near-tie limit 4 N = {4 * noise:.4g})")
        if gap is None or gap > 4 * noise:
            fail(f"{what}: request {r.rid}'s stream differs from {ref} past "
                 f"a near-tie")
        ties += 1
    return ties


def phase_spec(dev, kind: str, cfg, what: str, params, proposer: str,
               spec_k: int, base: dict | None = None,
               noise: float | None = None, profile: bool = False) -> dict:
    """A speculative main path: ``cfg`` behind ``SpecDecodeEngine`` with
    an n-gram proposer or a self-draft (``DraftModelProposer`` on the
    same weights), on the 16 requests of the serve phases, counters
    zeroed just before and read just after: the attention kernel once
    per layer per verify step and per draft decode step, the reduction
    twice per verify step and per first token. With ``base`` (the
    non-spec phase's streams) the streams must equal it under the
    near-tie rule of ``check_streams``; a self-draft rejection whose
    draft logit sits more than 4 N below the row's top fails."""
    import torch
    from repro_torch.serving.engine import SpecDecodeEngine
    from repro_torch.spec import DraftModelProposer, NGramProposer
    torch.cuda.reset_peak_memory_stats()
    prop = NGramProposer() if proposer == "ngram" else \
        DraftModelProposer(cfg, params)
    engine = SpecDecodeEngine(cfg, params, proposer=prop, spec_k=spec_k,
                              max_slots=8, max_context=1024, block_size=16,
                              prefill_chunk=256, device=dev)
    draft_calls = [0]
    if proposer == "draft":
        draft_decode = prop._decode

        def counted_decode(*args):
            draft_calls[0] += 1
            return draft_decode(*args)

        prop._decode = counted_decode
    probe = SpecProbe(engine) if base is not None else None
    reqs = make_requests(cfg)
    wall, step_ms, launches = serve_run(engine, reqs)
    if probe is not None:
        probe.detach()
    step_med = statistics.median(step_ms)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    st = engine.kv_stats
    emitted = sum(len(r.output) for r in reqs)
    label = f"{cfg.name} spec {proposer} k={spec_k}"
    log(f"[spec] {what} on {kind}, {proposer} proposer, spec_k {spec_k}: 16 "
        f"requests, {emitted} tokens emitted in {wall:.3f} s = "
        f"{emitted / wall:.2f} tok/s; {st['spec_steps']} verify steps, "
        f"median verify step {step_med:.3f} ms (proposer included); "
        f"{draft_calls[0]} draft decode steps; acceptance rate "
        f"{engine.acceptance_rate:.4f} ({st['spec_accepted']} of "
        f"{st['spec_drafted']} drafts), mean accepted length "
        f"{engine.mean_accepted_length:.4f} tokens per walk "
        f"({st['spec_emitted']} over {st['spec_slot_steps']} walks); peak "
        f"device memory {peak_gib:.2f} GiB")
    log(f"[spec] launching wrapper calls {launches}; guard trips "
        f"{st['guard_trips']}")
    attn = "paged_latent_attention" if cfg.mla is not None \
        else "paged_attention"
    check_served(label, engine, reqs, launches,
                 {attn: cfg.num_layers * (st["spec_steps"] + draft_calls[0]),
                  "fused_reduce": 2 * (st["spec_steps"] + len(reqs))})
    ties = 0
    if probe is not None:
        if proposer == "draft":
            for rid, idx, d, t, gap in probe.rejections:
                log(f"[spec] {label}: request {rid} token {idx}: draft {d} "
                    f"rejected for {t}, the draft's logit {gap:.4g} below "
                    f"the row's top (near-tie limit 4 N = {4 * noise:.4g})")
            if any(gap > 4 * noise for *_, gap in probe.rejections):
                fail(f"{label}: a self-draft rejection past a near-tie")
        ties = check_streams(label, reqs, base, probe, noise)
        log(f"[spec] {label}: streams equal the non-spec phase's but for "
            f"{ties} near-tie divergences; {len(probe.rejections)} "
            f"rejections")
    if profile:
        profile_decode(engine, cfg, what="verify")
    return dict(launches=launches, tok_s=emitted / wall, step_ms=step_med,
                acceptance=engine.acceptance_rate,
                accepted_len=engine.mean_accepted_length,
                draft_calls=draft_calls[0], ties=ties)


def profile_decode(engine, cfg, n_steps: int = 4, what: str = "decode",
                   knobs: dict | None = None) -> dict:
    """A steady decode (or verify) window under ``torch.profiler``: 8 fresh
    requests (256-token prompts) are prefilled, then ``n_steps`` engine
    steps (pure decode or verify, all 8 slots busy) are traced, and the
    requests are cancelled. Prints the
    device busy time per step, the device idle share of the window's wall
    time, kernels launched per step, and the kernels that take the most
    device time.

    The tracer now and then loses device events (``kernel_ms``), which
    would read low here. So a window counts only when it holds exactly
    ``n_steps`` x the layers' launches of the paged-attention kernels (one
    split and one merge per layer and step: B1's for a GQA model, B3's for
    MLA, whose split and merge run once per chunk of the table's
    partitions) and 2 x ``n_steps`` of ``fused_reduce_kernel``; otherwise
    the window is traced again with fresh requests after 0.5 s,
    ``PROFILE_TRIES`` times at most, and then the phase fails. A verify
    window's engine has an n-gram proposer, which launches nothing.
    ``knobs`` (temperature, top_k) make the window's requests sampled,
    each with its own seed; a list gives slot i its own ``knobs[i]``.
    Returns the window's wall and device-busy ms
    per step and its kernels per step."""
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
    # a request emits up to spec_k + 1 tokens per step, from the step that
    # prefills it on (one prompt chunk per step: the last request starts
    # max_slots steps after the first); none may finish before the
    # window ends
    per_step = getattr(engine, "spec_k", 0) + 1
    new_tokens = (engine.max_slots + n_steps) * per_step + 2
    g = torch.Generator().manual_seed(SEED + 1)
    lost = 0
    for attempt in range(PROFILE_TRIES):
        for i in range(engine.max_slots):
            prompt = torch.randint(0, cfg.vocab_size, (256,), generator=g)
            rid = 100 + engine.max_slots * attempt + i
            engine.submit(Request(rid=rid, prompt=prompt.tolist(),
                                  max_new_tokens=new_tokens,
                                  seed=rid,
                                  **(knobs[i] if isinstance(knobs, list)
                                     else knobs or {})))
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
        busy = len(engine.scheduler.decoding)
        engine.cancel_all()
        if busy != engine.max_slots:
            fail(f"{cfg.name} {what} window: {busy} of {engine.max_slots} "
                 f"slots still decoding at its end")
        kern = _device_kernels(prof)
        counts = {n: sum(ev.count for ev in kern if n in ev.key)
                  for n in names}
        reduce_n = sum(ev.count for ev in kern
                       if "fused_reduce_kernel" in ev.key)
        if all(c == want for c in counts.values()) and \
                reduce_n == 2 * n_steps:
            break
        lost += 1
        log(f"[profile] {cfg.name} {what} window, try {attempt + 1}: the "
            f"profiler lost device events ({counts}, want {want} each; "
            f"fused_reduce_kernel {reduce_n}, want {2 * n_steps}); tracing "
            f"again")
        time.sleep(0.5)
    else:
        fail(f"{cfg.name}: every {what} window lost device events")
    busy_ms = sum(_device_us(ev) for ev in kern) / 1e3 / n_steps
    per_step_k = sum(ev.count for ev in kern) / n_steps
    log(f"[profile] {cfg.name} {cfg.kv_dtype} {what} window, {n_steps} "
        f"steps x 8 slots: wall {wall_ms:.3f} ms/step, device busy "
        f"{busy_ms:.3f} ms/step, device idle share "
        f"{1 - busy_ms / wall_ms:.3f}, {per_step_k:.0f} kernels/step; "
        f"launches of {', '.join(names)}: {counts} (want {want} each), of "
        f"fused_reduce_kernel {reduce_n} (two calls per step, one kernel "
        f"each); windows lost to the profiler: {lost}")
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
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=per_step_k)


# ------------------------------------------------ keyed RNG and sampling --

F32_EPS = 2.0 ** -23
# jax 0.9.0 (threefry2x32, partitionable bits) on these keys
RNG_KNOWN = {"fold_in(key(3), 5)": [2464363587, 131619366],
             "fold_in(key(123), 7)": [4195957486, 134989543],
             "uniform bits": 1025456736, "uniform": 0.038874030113220215,
             "randint(fold_in(., 1), 0, 10)": 7,
             "categorical(., zeros(151936))": 14761}


def rng_known_answers(dev) -> dict:
    import torch
    from repro_torch.core import prng
    k = prng.fold_in(prng.key(123, device=dev), 7)
    u = prng.uniform(k)
    return {"fold_in(key(3), 5)":
            prng.fold_in(prng.key(3, device=dev), 5).tolist(),
            "fold_in(key(123), 7)": k.tolist(),
            "uniform bits": u.view(torch.int32).item(), "uniform": u.item(),
            "randint(fold_in(., 1), 0, 10)":
            int(prng.randint(prng.fold_in(k, 1), (), 0, 10)),
            "categorical(., zeros(151936))":
            int(prng.categorical(k, torch.zeros(151936, device=dev)))}


def phase_rng(dev) -> float:
    """``core/prng.py`` on the card against the same functions on the CPU,
    bitwise: ``random_bits`` over 2^20 counters for 64 keys, ``fold_in``
    chains, ``uniform`` and ``randint``; the known answers of jax 0.9.0
    on both; gumbel noise (through ``log``) card vs CPU, whose largest
    distance is printed in ulps and in f32 epsilons of max(1, |g|).
    Returns the latter, the near-tie bound of the sample phase."""
    import torch
    from repro_torch.core import prng
    t0 = time.perf_counter()
    for where in ("cpu", dev):
        got = rng_known_answers(where)
        if got != RNG_KNOWN:
            fail(f"prng known answers on {where}: {got} != {RNG_KNOWN}")
    keys = torch.stack([prng.fold_in(prng.key(s, device="cpu"), 7 * s + 1)
                        for s in range(64)])
    kd = keys.to(dev)
    n = 2 ** 20
    for c in range(0, 64, 16):
        if not torch.equal(prng.random_bits(kd[c:c + 16], (n,)).cpu(),
                           prng.random_bits(keys[c:c + 16], (n,))):
            fail(f"random_bits of keys {c}-{c + 15}: card != CPU")
    g = torch.Generator().manual_seed(SEED + 3)
    data = torch.randint(0, 2 ** 32, (64, 12), generator=g)
    ck, dk = keys, kd
    for j in range(12):
        ck = prng.fold_in(ck, data[:, j])
        dk = prng.fold_in(dk, data[:, j].to(dev))
    if not torch.equal(dk.cpu(), ck):
        fail("fold_in chains: card != CPU")
    for lo, hi in ((0.0, 1.0), (-3.0, 2.5)):
        if not torch.equal(
                prng.uniform(kd, (2 ** 16,), lo, hi).cpu().view(torch.int32),
                prng.uniform(keys, (2 ** 16,), lo, hi).view(torch.int32)):
            fail(f"uniform [{lo}, {hi}): card != CPU")
    for i in range(8):
        if not torch.equal(prng.randint(kd[i], (4096,), -7, 151936).cpu(),
                           prng.randint(keys[i], (4096,), -7, 151936)):
            fail(f"randint of key {i}: card != CPU")
    gc = prng.gumbel(keys[:16], (151936,))
    gd = prng.gumbel(kd[:16], (151936,)).cpu()
    ulps = int((gd.view(torch.int32).long()
                - gc.view(torch.int32).long()).abs().max())
    eps = float(((gd.double() - gc.double()).abs()
                 / (F32_EPS * gc.double().abs().clamp_min(1.0))).max())
    # the host rules draw one scalar at a time: a single CPU key runs the
    # rounds on Python ints; the same draws through the tensor ops (a
    # batch of one key) must be bitwise equal, each timed on the host
    def host_draws(batched: bool) -> tuple[list, float]:
        t = time.perf_counter()
        out = []
        for i in range(200):
            k = keys[i % 64]
            if batched:
                u = prng.uniform(prng.fold_in(k[None], torch.tensor(i)))[0]
            else:
                u = prng.uniform(prng.fold_in(k, i))
            out.append(u.view(torch.int32).item())
        return out, 1e6 * (time.perf_counter() - t) / 200
    host_draws(True)
    scalar, scalar_us = host_draws(False)
    tensor, tensor_us = host_draws(True)
    if scalar != tensor:
        fail("host scalar draws: Python-int rounds != tensor ops")
    log(f"[rng] core/prng.py card == CPU bitwise: random_bits 64 keys x 2^20 "
        f"counters, fold_in chains of 12, uniform 64 x 2^16 (two ranges), "
        f"randint 8 x 4096; known answers of jax 0.9.0 on both {RNG_KNOWN}; "
        f"gumbel 16 x 151936 card vs CPU: max distance {ulps} ulps, "
        f"{eps:.3f} f32 eps of max(1, |g|); a host fold_in + uniform draw "
        f"{scalar_us:.1f} us on Python ints, {tensor_us:.1f} us through "
        f"tensor ops (200 draws, bitwise equal); "
        f"{time.perf_counter() - t0:.1f} s")
    return eps


def _perturbed_gap(row, temp, key, top_k) -> tuple[float, float]:
    """The top two of gumbel + scaled (and truncated) logits, on the CPU:
    (gap, |top|)."""
    import torch
    from repro_torch.core import prng
    z = row / max(temp, 1e-6)
    if top_k:
        kth = torch.topk(z, top_k).values[-1]
        z = torch.where(z < kth, float("-inf"), z)
    top2 = torch.topk(prng.gumbel(key, (row.shape[-1],)) + z, 2).values
    return float(top2[0] - top2[1]), float(top2[0].abs())


def phase_sample(dev, gumbel_eps: float) -> None:
    """``_sample_rows`` on 8 f32 logit rows of width 151936, card against
    the CPU at top_k 0, 50 and 1: tokens equal, except where the two
    largest perturbed logits lie within twice the gumbel distance of the
    rng phase (printed). Then a Monte-Carlo check of the card's draws: a
    64-wide row, 2^16 keyed draws, total-variation distance to
    ``target_dist`` under 0.02."""
    import numpy as np
    import torch
    from repro_torch.core import prng
    from repro_torch.serving.engine import _sample_rows
    from repro_torch.spec.sampler import target_dist
    g = torch.Generator().manual_seed(SEED + 2)
    rows = torch.randn(8, 151936, generator=g) * 3
    temps = torch.full((8,), 0.8)
    keys = torch.stack([prng.fold_in(prng.key(100 + i, device="cpu"), i)
                        for i in range(8)])
    ties = 0
    for top_k in (0, 50, 1):
        cpu = _sample_rows(rows, temps, keys, top_k)
        card = _sample_rows(rows.to(dev), temps.to(dev), keys.to(dev),
                            top_k).cpu()
        for i in torch.nonzero(cpu != card)[:, 0].tolist():
            gap, top = _perturbed_gap(rows[i], 0.8, keys[i], top_k)
            limit = 2 * gumbel_eps * F32_EPS * max(1.0, top)
            log(f"[sample] top_k {top_k} row {i}: card {int(card[i])} vs CPU "
                f"{int(cpu[i])}; perturbed top-2 gap {gap:.3g}, near-tie "
                f"limit {limit:.3g}")
            if gap > limit:
                fail(f"_sample_rows top_k {top_k} row {i}: card and CPU "
                     f"draw differently past a near-tie")
            ties += 1
    row = torch.randn(64, generator=g) * 2
    n = 2 ** 16
    mc_keys = prng.fold_in(prng.key(SEED, device=dev),
                           torch.arange(n, device=dev))
    tvs = {}
    for top_k, temp in ((0, 1.0), (10, 0.8)):
        draws = _sample_rows(row.to(dev).expand(n, 64),
                             torch.full((n,), temp, device=dev), mc_keys,
                             top_k)
        freq = torch.bincount(draws, minlength=64).cpu().double().numpy() / n
        tv = 0.5 * float(np.abs(freq - target_dist(row.numpy(), temp,
                                                   top_k)).sum())
        tvs[f"top_k {top_k} t {temp}"] = round(tv, 5)
        if not tv < 0.02:
            fail(f"Monte-Carlo draws (top_k {top_k}): total variation {tv}")
    log(f"[sample] _sample_rows 8 x 151936 f32, card vs CPU at top_k 0, 50, "
        f"1: tokens equal but {ties} near-ties; Monte-Carlo 2^16 keyed "
        f"draws on the card from a 64-wide row, total variation to "
        f"target_dist {tvs} (limit 0.02)")


# the sampled serve phase's mix, by rid: 8 at temperature 0.8 / top_k 50,
# 4 at 1.0 / full vocabulary, 2 at top_k 1, 2 greedy (rid i takes entry
# 5 i mod 16, spreading each kind over the prompt lengths)
SAMPLED_MIX = ([dict(temperature=0.8, top_k=50)] * 8
               + [dict(temperature=1.0, top_k=0)] * 4
               + [dict(temperature=0.7, top_k=1)] * 2 + [dict()] * 2)


def sampled_requests(cfg, knobs=None, n: int = 16, new_tokens: int = 32):
    """``make_requests`` with sampling knobs: ``knobs`` for every request,
    or the ``SAMPLED_MIX`` by rid; seed 1000 + rid."""
    reqs = make_requests(cfg, n, new_tokens)
    for r in reqs:
        k = knobs if knobs is not None else SAMPLED_MIX[(5 * r.rid) % 16]
        r.temperature = k.get("temperature", 0.0)
        r.top_k = k.get("top_k", 0)
        r.seed = 1000 + r.rid
    return reqs


def phase_serve_sampled(dev, kind: str, cfg, what: str, params, base: dict,
                        greedy_prof: dict) -> dict:
    """qwen1.5-0.5b behind ``DecodeEngine`` over bf16 pools with the
    ``SAMPLED_MIX``, counters zeroed just before and read just after:
    every request finishes; the greedy and top_k 1 streams equal the bf16
    phase's (the same slots and shapes, so bitwise); a second engine fed
    the requests in reverse order gives every stream bitwise (a draw is
    keyed on (seed, emit index) only); the attention kernel launched once
    per layer per decode step and the reduction twice per step and per
    first token. Ends in a profiled window of sampled decode steps."""
    import torch
    from repro_torch.serving.engine import DecodeEngine

    def engine():
        return DecodeEngine(cfg, params, max_slots=8, max_context=1024,
                            block_size=16, prefill_chunk=256, device=dev)

    eng = engine()
    reqs = sampled_requests(cfg)
    wall, step_ms, launches = serve_run(eng, reqs)
    st = eng.kv_stats
    check_served(f"{cfg.name} sampled serve", eng, reqs, launches,
                 {"paged_attention": cfg.num_layers * st["decode_steps"],
                  "fused_reduce": 2 * (st["decode_steps"] + len(reqs))})
    greedy = [r.rid for r in reqs if r.temperature <= 0.0 or r.top_k == 1]
    bad = [rid for rid in greedy if reqs[rid].output != base[rid]]
    if bad:
        fail(f"sampled serve: greedy / top_k 1 requests {bad} differ from "
             f"the bf16 phase's streams")
    again = sampled_requests(cfg)
    serve_run(engine(), list(reversed(again)))
    moved = [r.rid for r in again if r.output != reqs[r.rid].output]
    if moved:
        fail(f"sampled serve: requests {moved} changed when submitted in "
             f"reverse order")
    emitted = sum(len(r.output) for r in reqs)
    step_med = statistics.median(step_ms)
    log(f"[serve] {what} sampled (8 at t 0.8 / top_k 50, 4 at t 1.0, 2 at "
        f"top_k 1, 2 greedy) bf16 pools on {kind}: {emitted} tokens in "
        f"{wall:.3f} s = {emitted / wall:.2f} tok/s; {st['decode_steps']} "
        f"decode steps, median step {step_med:.3f} ms; greedy and top_k 1 "
        f"streams {sorted(greedy)} equal the bf16 phase's; reverse-order "
        f"run bitwise equal in all 16 streams; launching wrapper calls "
        f"{launches}")
    prof = profile_decode(eng, cfg, what="sampled decode",
                          knobs=dict(temperature=0.8, top_k=50))
    mix = ([dict(temperature=0.8, top_k=50)] * 3
           + [dict(temperature=1.0, top_k=0)] * 3
           + [dict(temperature=0.7, top_k=1)] * 2)
    prof3 = profile_decode(eng, cfg, what="sampled decode, 3 top_k groups",
                           knobs=mix)
    log(f"[serve] per decode step of 8 slots: sampled, one top_k group "
        f"{prof['kernels']:.0f} kernels, device busy {prof['busy_ms']:.3f} "
        f"ms, wall {prof['wall_ms']:.3f} ms; sampled, three top_k groups "
        f"(50, 0, 1) {prof3['kernels']:.0f} kernels, busy "
        f"{prof3['busy_ms']:.3f} ms, wall {prof3['wall_ms']:.3f} ms; greedy "
        f"{greedy_prof['kernels']:.0f} kernels, busy "
        f"{greedy_prof['busy_ms']:.3f} ms, wall "
        f"{greedy_prof['wall_ms']:.3f} ms")
    return dict(launches=launches, tok_s=emitted / wall, step_ms=step_med,
                profile=prof)


def phase_spec_sampled(dev, kind: str, cfg, what: str, params, proposer: str,
                       spec_k: int) -> dict:
    """qwen1.5-0.5b behind ``SpecDecodeEngine`` (n-gram or self-draft) with
    every request at temperature 0.8 / top_k 50, run twice on fresh
    engines: streams, acceptance, ``kv_stats`` and launch counters must be
    the same, every request must finish, and the counters must equal the
    calls (the attention kernel once per layer per verify step and per
    draft decode step, the reduction twice per verify step and per first
    token). Prints the host time per step spent in ``rejection_sample``
    and in the proposer's call (draft decodes included). The n-gram path
    ends in a profiled window of sampled verify steps."""
    import torch
    from repro_torch.serving.engine import SpecDecodeEngine
    from repro_torch.spec import DraftModelProposer, NGramProposer, sampler
    knobs = dict(temperature=0.8, top_k=50)
    reject = sampler.rejection_sample

    def run():
        prop = NGramProposer() if proposer == "ngram" else \
            DraftModelProposer(cfg, params)
        engine = SpecDecodeEngine(cfg, params, proposer=prop, spec_k=spec_k,
                                  max_slots=8, max_context=1024,
                                  block_size=16, prefill_chunk=256,
                                  device=dev)
        cost = {"reject": 0.0, "propose": 0.0, "draft_calls": 0}
        propose = prop.propose

        def timed_reject(*a):
            t = time.perf_counter()
            out = reject(*a)
            cost["reject"] += time.perf_counter() - t
            return out

        def timed_propose(*a):
            t = time.perf_counter()
            out = propose(*a)
            cost["propose"] += time.perf_counter() - t
            return out

        prop.propose = timed_propose
        if proposer == "draft":
            draft_decode = prop._decode

            def counted_decode(*a):
                cost["draft_calls"] += 1
                return draft_decode(*a)

            prop._decode = counted_decode
        sampler.rejection_sample = timed_reject
        try:
            reqs = sampled_requests(cfg, knobs)
            wall, step_ms, launches = serve_run(engine, reqs)
        finally:
            sampler.rejection_sample = reject
        return engine, reqs, wall, step_ms, launches, cost

    eng, reqs, wall, step_ms, launches, cost = run()
    st = dict(eng.kv_stats)
    label = f"{cfg.name} sampled spec {proposer} k={spec_k}"
    check_served(label, eng, reqs, launches,
                 {"paged_attention": cfg.num_layers
                  * (st["spec_steps"] + cost["draft_calls"]),
                  "fused_reduce": 2 * (st["spec_steps"] + len(reqs))})
    eng2, reqs2, _, _, launches2, _ = run()
    if [r.output for r in reqs2] != [r.output for r in reqs] or \
            dict(eng2.kv_stats) != st or launches2 != launches or \
            eng2.acceptance_rate != eng.acceptance_rate:
        fail(f"{label}: a second run differs in streams, counters or "
             f"acceptance")
    del eng2
    emitted = sum(len(r.output) for r in reqs)
    step_med = statistics.median(step_ms)
    steps = st["spec_steps"]
    log(f"[spec] {what} sampled (t 0.8 / top_k 50) on {kind}, {proposer} "
        f"proposer, spec_k {spec_k}: {emitted} tokens in {wall:.3f} s = "
        f"{emitted / wall:.2f} tok/s; {steps} verify steps, median step "
        f"{step_med:.3f} ms; acceptance rate {eng.acceptance_rate:.4f} "
        f"({st['spec_accepted']} of {st['spec_drafted']}), "
        f"{eng.mean_accepted_length:.4f} tokens per walk; host ms per step: "
        f"rejection_sample {1e3 * cost['reject'] / steps:.3f}, drafting "
        f"{1e3 * cost['propose'] / steps:.3f} (the proposer's call, its "
        f"{cost['draft_calls']} draft decode steps included); a second run "
        f"bitwise the same; launching wrapper "
        f"calls {launches}")
    prof = None
    if proposer == "ngram":
        prof = profile_decode(eng, cfg, what="sampled verify", knobs=knobs)
    return dict(launches=launches, tok_s=emitted / wall, step_ms=step_med,
                acceptance=eng.acceptance_rate,
                accepted_len=eng.mean_accepted_length, ties=0, profile=prof)


# the fault phase: 8 requests of 16 new tokens; faults at fixed steps
FAULTS = (dict(site="alloc_fail", step=1), dict(site="kv_corrupt", step=14),
          dict(site="logit_nan", step=18))
STALLS = (dict(site="proposer_stall", step=12),
          dict(site="proposer_stall", step=15),
          dict(site="proposer_stall", step=20))
EXPIRES, CANCELS, CANCEL_AT = 6, 7, 12


class _CallCount:
    """Counts the model steps and ``_logit_stats`` calls of the engines it
    wraps (the degraded tier's too), to hold the launch counters to."""

    def __init__(self):
        from repro_torch.serving import engine as engine_mod
        self.mod, self.stats_fn = engine_mod, engine_mod._logit_stats
        self.model_steps = 0
        self.stats = 0

        def counted_stats(*a):
            self.stats += 1
            return self.stats_fn(*a)

        engine_mod._logit_stats = counted_stats

    def wrap(self, engine):
        for name in ("_decode", "_verify"):
            fn = getattr(engine, name, None)
            if fn is not None:
                setattr(engine, name, self._counted(fn))
        return engine

    def _counted(self, fn):
        def counted(*a):
            self.model_steps += 1
            return fn(*a)
        return counted

    def close(self) -> None:
        self.mod._logit_stats = self.stats_fn


def fault_run(dev, cfg, params, calls: _CallCount):
    """One ``FailoverServer`` run over a bf16 ``DecodeEngine`` with the
    ``FAULTS`` armed, request ``EXPIRES`` on a deadline of 6 steps and
    request ``CANCELS`` cancelled at step ``CANCEL_AT``. Returns the
    server, the injector, the requests, the wall time (s), the host time
    of each server step (ms) and the launch counters."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import (DecodeEngine, FailoverServer,
                                     FaultInjector, FaultSpec,
                                     degraded_engine)
    inj = FaultInjector(SEED, [FaultSpec(**f) for f in FAULTS])
    primary = calls.wrap(DecodeEngine(cfg, params, max_slots=8,
                                      max_context=1024, block_size=16,
                                      prefill_chunk=256, device=dev,
                                      fault_injector=inj))
    server = FailoverServer(primary, lambda: calls.wrap(
        degraded_engine(primary)))
    reqs = make_requests(cfg, n=8, new_tokens=16)
    reqs[EXPIRES].deadline_steps = 6
    for r in reqs:
        server.submit(r)
    ops.reset_launches()
    step_ms = []
    t0 = time.perf_counter()
    for step in range(1, 500):
        if not server.num_unfinished:
            break
        if step == CANCEL_AT and not primary.cancel(CANCELS):
            fail(f"faults: request {CANCELS} was not in flight at step "
                 f"{CANCEL_AT}")
        t = time.perf_counter()
        server.step()
        step_ms.append(1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if server.num_unfinished:
        fail("faults: the failover server did not finish in 500 steps")
    return server, inj, reqs, wall, step_ms, dict(ops.launches)


def phase_faults(dev, kind: str, cfg, params, base: dict,
                 noise: float) -> tuple[dict, dict]:
    """Deterministic fault injection with failover at full width, twice
    with one seed: a ``FailoverServer`` over a bf16 ``DecodeEngine`` with
    ``alloc_fail``, ``kv_corrupt`` and ``logit_nan`` at fixed steps, one
    request on a deadline and one cancelled. Every guard-tripped request
    is retried on the degraded engine and finishes there (or is reported
    failed); every other request but the cancelled and the expired one
    finishes; the streams that finish equal the bf16 phase's (first 16
    tokens); the cancelled and the expired request hold no slot or block;
    no allocator holds a block at the end; both runs fire the same (step,
    site, victim) list; the launch counters equal the model steps (one
    attention kernel per layer) and the ``_logit_stats`` calls (two
    reductions each). Then a ``SpecDecodeEngine`` (n-gram, spec_k 4) with
    ``proposer_stall`` at fixed steps: the stalls are counted and its
    streams equal the bf16 phase's but past a near-tie. Returns the two
    paths apart, the failover server's and the stalled verify path's."""
    from repro_torch.serving import FaultInjector, FaultSpec, SpecDecodeEngine
    from repro_torch.spec import NGramProposer
    t0 = time.perf_counter()
    logs, outs, rates = [], [], []
    total: dict = {}
    for attempt in range(2):
        calls = _CallCount()
        try:
            server, inj, reqs, wall, step_ms, launches = fault_run(
                dev, cfg, params, calls)
        finally:
            calls.close()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        full = dict.fromkeys(launches, 0)
        full.update(paged_attention=cfg.num_layers * calls.model_steps,
                    fused_reduce=2 * calls.stats)
        if launches != full:
            fail(f"faults: launch counters {launches} != {full}")
        primary, degraded = server.primary, server.degraded
        gone = {EXPIRES: "expired", CANCELS: "cancelled"}
        for rid, state in gone.items():
            r = reqs[rid]
            if r.state != state or r.blocks or r.slot is not None:
                fail(f"faults: request {rid} is {r.state} holding "
                     f"{len(r.blocks)} blocks, slot {r.slot} (want "
                     f"{state}, nothing held)")
        if primary.kv_stats["expired"] != 1 or \
                primary.kv_stats["cancelled"] != 1:
            fail(f"faults: expired / cancelled counters "
                 f"{primary.kv_stats['expired']}, "
                 f"{primary.kv_stats['cancelled']}")
        retried = [r.rid for r in server.retried]
        failed = [r.rid for r in server.failed]
        sites = [s for _, s, _ in inj.log]
        if sorted(sites) != sorted(f["site"] for f in FAULTS) or \
                primary.kv_stats["alloc_faults"] != 1:
            fail(f"faults: fired {inj.log}, alloc faults "
                 f"{primary.kv_stats['alloc_faults']}")
        if primary.kv_stats["guard_trips"] != len(retried) or \
                not retried or degraded is None:
            fail(f"faults: {primary.kv_stats['guard_trips']} guard trips, "
                 f"retried {retried}")
        for r in reqs:
            if r.rid in gone or r.rid in failed:
                continue
            if not r.done or r.output != base[r.rid][:16]:
                fail(f"faults: request {r.rid} ({r.state}, retried "
                     f"{r.rid in retried}) did not finish with the bf16 "
                     f"phase's stream")
        held = [e.scheduler.allocator.num_held for e in (primary, degraded)]
        if any(held):
            fail(f"faults: allocators still hold {held} blocks")
        logs.append(inj.log)
        outs.append([r.output for r in reqs])
        rates.append((sum(len(r.output) for r in reqs) / wall,
                      statistics.median(step_ms)))
        if attempt == 0:
            log(f"[faults] qwen1.5-0.5b bf16 FailoverServer on {kind}, 8 "
                f"requests of 16 tokens: fired (step, site, detail) "
                f"{inj.log}; guard trips {primary.kv_stats['guard_trips']}, "
                f"retried on the degraded bf16 engine {retried} (finished "
                f"there, streams equal the bf16 phase's), failed {failed}; "
                f"request {EXPIRES} expired and {CANCELS} cancelled, "
                f"nothing held; allocators empty; {wall:.3f} s; launching "
                f"wrapper calls {launches} = {calls.model_steps} model "
                f"steps, {calls.stats} logit-stats calls")
    if logs[0] != logs[1] or outs[0] != outs[1]:
        fail(f"faults: two runs with one seed differ: {logs}")
    inj = FaultInjector(SEED, [FaultSpec(**f) for f in STALLS])
    engine = SpecDecodeEngine(cfg, params, proposer=NGramProposer(),
                              spec_k=VERIFY_K, max_slots=8,
                              max_context=1024, block_size=16,
                              prefill_chunk=256, device=dev,
                              fault_injector=inj)
    probe = SpecProbe(engine)
    reqs = make_requests(cfg, n=8, new_tokens=16)
    stall_wall, stall_ms, launches = serve_run(engine, reqs)
    probe.detach()
    st = engine.kv_stats
    check_served(f"{cfg.name} spec with proposer stalls", engine, reqs,
                 launches,
                 {"paged_attention": cfg.num_layers * st["spec_steps"],
                  "fused_reduce": 2 * (st["spec_steps"] + len(reqs))},
                 new_tokens=16)
    if st["proposer_stalls"] != len(STALLS) or len(inj.log) != len(STALLS):
        fail(f"faults: {st['proposer_stalls']} proposer stalls, fired "
             f"{inj.log}")
    ties = check_streams("spec with proposer stalls", reqs,
                         {rid: s[:16] for rid, s in base.items()}, probe,
                         noise)
    log(f"[faults] qwen1.5-0.5b SpecDecodeEngine n-gram k={VERIFY_K} with "
        f"proposer_stall at steps {[f['step'] for f in STALLS]}: "
        f"{st['proposer_stalls']} stalls degraded to plain verify steps, "
        f"all 8 requests finished, streams equal the bf16 phase's but for "
        f"{ties} near-ties; two fault runs fired the same list; "
        f"{time.perf_counter() - t0:.1f} s")
    return (dict(launches=total, tok_s=rates[0][0], step_ms=rates[0][1]),
            dict(launches=launches,
                 tok_s=sum(len(r.output) for r in reqs) / stall_wall,
                 step_ms=statistics.median(stall_ms)))


# ----------------------- prefix caching, session KV, preemption, spill ----

SYS_TOKENS = 256                    # one prefill chunk: 16 blocks
SERVE_KW = dict(max_slots=8, max_context=1024, block_size=16,
                prefill_chunk=256)


class GapProbe:
    """Beside a ``DecodeEngine`` run: the top-2 gap of the logit row each
    token was chosen from, by request and output index (the near-tie rule
    of ``check_streams``). Wraps ``engine._choose``: a top-2 over the
    step's rows and one small transfer per call (torch ops, no counted
    launch)."""

    def __init__(self, engine):
        import torch
        self.engine = engine
        self.gaps: dict = {}
        choose = engine._choose

        def probed(rows, row_reqs):
            top2 = torch.topk(rows.to(torch.float32), 2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).cpu().tolist()
            for idx, req in row_reqs:
                self.gaps.setdefault(req.rid, {})[len(req.output)] = gap[idx]
            return choose(rows, row_reqs)

        engine._choose = probed

    def detach(self) -> None:
        del self.engine._choose


def counted_run(what: str, engine, reqs, cfg, new_tokens: int = 32) -> dict:
    """``serve_run`` with the counters held to the calls: the attention
    kernel once per layer per decode step, the reduction twice per decode
    step and per first token."""
    steps0 = engine.kv_stats["decode_steps"]
    wall, step_ms, launches = serve_run(engine, reqs)
    steps = engine.kv_stats["decode_steps"] - steps0
    check_served(what, engine, reqs, launches,
                 {"paged_attention": cfg.num_layers * steps,
                  "fused_reduce": 2 * (steps + len(reqs))}, new_tokens)
    return dict(launches=launches, wall=wall, step_ms=step_ms,
                emitted=sum(len(r.output) for r in reqs))


def merge_runs(runs: list) -> dict:
    """One path's record from several counted runs."""
    launches: dict = {}
    for r in runs:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return dict(launches=launches,
                tok_s=sum(r["emitted"] for r in runs)
                / sum(r["wall"] for r in runs),
                step_ms=statistics.median(
                    [t for r in runs for t in r["step_ms"]]))


def random_tokens(g, cfg, lo: int, hi: int) -> list:
    """A seeded run of lo..hi random token ids."""
    import torch
    k = int(torch.randint(lo, hi + 1, (1,), generator=g))
    return torch.randint(0, cfg.vocab_size, (k,), generator=g).tolist()


def system_prompt(cfg) -> list:
    import torch
    return random_tokens(torch.Generator().manual_seed(SEED + 1), cfg,
                         SYS_TOKENS, SYS_TOKENS)


def hit_requests(cfg, n: int, seed: int, lo: int = 32, hi: int = 224):
    """A factory of ``n`` fresh requests: the system prompt + lo..hi
    unique tokens, 32 new tokens each (the same prompts every call). The
    unique parts start with distinct tokens (1, 2, ...; the warm-up's
    with 0), so no request shares a partial block past the system
    prompt with another: every hit is the 256 tokens."""
    import torch
    from repro_torch.serving.engine import Request
    g = torch.Generator().manual_seed(seed)
    sys_p = system_prompt(cfg)
    prompts = [sys_p + [i + 1] + random_tokens(g, cfg, lo, hi)[1:]
               for i in range(n)]
    return lambda: [Request(rid=i, prompt=list(p), max_new_tokens=32)
                    for i, p in enumerate(prompts)]


def check_bitwise(what: str, got, want) -> None:
    for a, b in zip(got, want):
        if a.output != b.output or a.logprobs != b.logprobs:
            fail(f"{what}: request {a.rid}'s tokens or logprobs are not "
                 f"bitwise the cold run's")


def warm_up(engine, cfg) -> None:
    """One request carrying the system prompt; its history is cached."""
    import torch
    from repro_torch.serving.engine import Request
    w = Request(rid=1000, prompt=system_prompt(cfg) + [0] + random_tokens(
        torch.Generator().manual_seed(SEED + 2), cfg, 31, 31),
        max_new_tokens=32)
    engine.submit(w)
    engine.run_until_done()


def prefix_pair(dev, cfg, params, n: int) -> tuple:
    """A warm-up, then ``n`` hit requests on a prefix-caching engine, and
    the same ``n`` on a cold engine; both runs counted."""
    from repro_torch.serving.engine import DecodeEngine
    make = hit_requests(cfg, n, SEED + 3)
    warm = DecodeEngine(cfg, params, prefix_cache=True, device=dev,
                        **SERVE_KW)
    warm_up(warm, cfg)
    hits0 = warm.kv_stats["prefix_hit_tokens"]
    tok0 = warm.kv_stats["prefill_tokens"]
    wreqs = make()
    wrun = counted_run(f"prefix {cfg.kv_dtype} warm", warm, wreqs, cfg)
    cold = DecodeEngine(cfg, params, device=dev, **SERVE_KW)
    creqs = make()
    crun = counted_run(f"prefix {cfg.kv_dtype} cold", cold, creqs, cfg)
    check_bitwise(f"prefix {cfg.kv_dtype}", wreqs, creqs)
    hits = warm.kv_stats["prefix_hit_tokens"] - hits0
    if hits != n * SYS_TOKENS or any(r.prefix_hit != SYS_TOKENS
                                     for r in wreqs):
        fail(f"prefix {cfg.kv_dtype}: hit tokens {hits}, hits "
             f"{[r.prefix_hit for r in wreqs]} (want {SYS_TOKENS} each)")
    saved = cold.kv_stats["prefill_tokens"] - \
        (warm.kv_stats["prefill_tokens"] - tok0)
    return warm, cold, wrun, crun, saved


def phase_prefix(dev, kind: str, cfg, params, noise: float) -> dict:
    """Prefix caching at full width: a warm-up request carries a
    256-token system prompt (one prefill chunk, 16 blocks); then 16
    requests of that prompt + 32-224 unique tokens (32 new each, 8
    slots) on the prefix-caching engine and on a cold one. Each hit
    starts its prefill at a chunk boundary of its cold run, so tokens
    and logprobs must be bitwise equal, and every request must hit the
    256 tokens. A request diverging mid-block (a copy-on-write hit) is
    held to its cold run under the near-tie rule; int8 and fp8 pools run
    the hit pair at 4 requests, bitwise. Counters on every run."""
    import torch
    from repro_torch.serving.engine import Request
    t0 = time.perf_counter()
    warm, cold, wrun, crun, saved = prefix_pair(dev, cfg, params, 16)
    runs = [wrun, crun]
    w, c = merge_runs([wrun]), merge_runs([crun])
    log(f"[prefix] qwen1.5-0.5b bf16 on {kind}: 16 requests of the "
        f"{SYS_TOKENS}-token system prompt + 32-224 tokens, 32 new each: "
        f"every request hit {SYS_TOKENS} tokens "
        f"(prefix_hit_tokens {16 * SYS_TOKENS}), tokens and logprobs "
        f"bitwise the cold engine's; prefill tokens "
        f"{cold.kv_stats['prefill_tokens']} cold vs "
        f"{cold.kv_stats['prefill_tokens'] - saved} warm ({saved} saved); "
        f"warm {w['tok_s']:.3f} tok/s, median step {w['step_ms']:.3f} ms; "
        f"cold {c['tok_s']:.3f} tok/s, median step {c['step_ms']:.3f} ms; "
        f"prefill chunks {warm.kv_stats['prefill_chunks']} warm (warm-up "
        f"included) vs {cold.kv_stats['prefill_chunks']} cold")
    # a copy-on-write hit: diverges inside block 12
    g = torch.Generator().manual_seed(SEED + 4)
    cow_p = system_prompt(cfg)[:200] + random_tokens(g, cfg, 40, 40)
    wq = Request(rid=50, prompt=list(cow_p), max_new_tokens=32)
    cq = Request(rid=50, prompt=list(cow_p), max_new_tokens=32)
    cow0 = warm.kv_stats["prefix_cow_blocks"]
    probe = GapProbe(warm)
    runs.append(counted_run("prefix copy-on-write warm", warm, [wq], cfg))
    probe.detach()
    runs.append(counted_run("prefix copy-on-write cold", cold, [cq], cfg))
    if wq.prefix_hit != 200 or warm.kv_stats["prefix_cow_blocks"] != cow0 + 1:
        fail(f"prefix copy-on-write: hit {wq.prefix_hit}, copies "
             f"{warm.kv_stats['prefix_cow_blocks'] - cow0}")
    ties = check_streams("prefix copy-on-write", [wq],
                         {50: cq.output}, probe, noise, tag="prefix",
                         ref="the cold run")
    lp = [abs(a - b) for a, b, x, y in zip(wq.logprobs, cq.logprobs,
                                          wq.output, cq.output) if x == y]
    log(f"[prefix] copy-on-write request: {len(cow_p)} tokens diverging "
        f"from the system prompt at 200 (inside block 12): hit 200, one "
        f"block copied, remainder prefilled at M = 40 (cold M = 240); "
        f"stream vs cold: {ties} near-tie divergences, max |logprob diff| "
        f"{max(lp) if lp else 0.0:.4g} before any")
    for kvd in ("int8", "fp8"):
        qcfg = cfg.with_(kv_dtype=kvd)
        qw, qc, a, b, qsaved = prefix_pair(dev, qcfg, params, 4)
        runs += [a, b]
        log(f"[prefix] {kvd} pools: 4 hit requests bitwise the cold "
            f"engine's, {4 * SYS_TOKENS} hit tokens, {qsaved} prefill "
            f"tokens saved")
    log(f"[prefix] {time.perf_counter() - t0:.1f} s")
    return merge_runs(runs)


def kv_entries(engine, req, lo: int, hi: int):
    """[L, hi - lo, H, D] f32 K and V entries (dequantized) at positions
    lo..hi-1 of ``req``'s blocks."""
    import torch
    from repro_torch.quant import core as qcore
    bs = engine.layout.block_size
    pos = torch.arange(lo, hi)
    blk = torch.tensor(req.blocks, dtype=torch.long)[pos // bs]
    blk, off = blk.to(engine.device), (pos % bs).to(engine.device)
    out = []
    for name in ("kpool", "vpool"):
        v = qcore.cast_f32(engine.caches[name][:, blk, off])
        if SCALE_OF[name] in engine.caches:
            v = v * engine.caches[SCALE_OF[name]][:, blk, off][..., None]
        out.append(v)
    return out


def storage_steps(a: list, e: list, kv_dtype: str):
    """Per layer, the largest |a - e| entry in storage steps (the format's
    step times the row's max |value|)."""
    import torch
    step = STORAGE_STEP[kv_dtype]
    worst = None
    for x, y in zip(a, e):
        amax = y.abs().amax(dim=-1, keepdim=True)
        d = ((x - y).abs() / (step * amax + 1e-6)).flatten(1).amax(1)
        worst = d if worst is None else torch.maximum(worst, d)
    return worst


def capture_retired(engine, spans: dict, store: dict,
                    cut_at_hit: bool = False) -> None:
    """At retirement, keep the K/V entries of ``spans[rid]`` = (lo, hi)
    (with ``cut_at_hit``, only below the request's prefix hit, and the
    span kept is written back to ``spans``)."""
    retire = engine._on_retire

    def on_retire(req):
        retire(req)
        lo, hi = spans.get(req.rid, (0, 0))
        if cut_at_hit:
            hi = min(hi, req.prefix_hit)
            spans[req.rid] = (lo, hi)
        if hi > lo:
            store[req.rid] = kv_entries(engine, req, lo, hi)

    engine._on_retire = on_retire


def conversation_turns(cfg, seed: int, n_conv: int = 8, turns: int = 3):
    """Turn 1 of each conversation: the system prompt + 32-96 tokens; each
    later turn adds 16-48 user tokens to the history. Returns the first
    prompts and the user tokens of each later turn, drawn from ``seed``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    sys_p = system_prompt(cfg)
    first = [sys_p + random_tokens(g, cfg, 32, 96) for _ in range(n_conv)]
    later = [[random_tokens(g, cfg, 16, 48) for _ in range(n_conv)]
             for _ in range(turns - 1)]
    return first, later


# The session pairs' own noise. A later turn's prefill reads the previous
# turn's decode-written K/V entries, which round apart from the
# prefill-written entries of the cold replay, so warm and cold logits part
# by more than the verify phase's N. Both limits are fixed readings of
# sound runs, taken by ``tools/session_noise.py`` on conversations of
# seeds ``SESSION_CALIB_SEEDS`` (not the phase's ``SESSION_SEED``) on an
# NVIDIA H100 80GB HBM3, 700.00 W: the largest |warm - cold| logprob of a
# token emitted before the streams part (seed 105; the six seeds read
# 0.150-0.238), and the largest decode-written vs prefill-written entry
# distance of any layer, in storage steps (seed 102, layer 23; 27.6-43.1).
# Re-measure them with that script when the served path's numerics change.
SESSION_SEED = SEED + 5
SESSION_CALIB_SEEDS = tuple(range(SEED + 100, SEED + 106))
SESSION_NOISE = 0.2379593849182129
SESSION_STEPS = 43.149


def session_pairs(dev, cfg, params, seed: int) -> dict:
    """8 conversations of 3 turns from ``seed`` (turn 1 the system prompt
    + 32-96 tokens, later turns + 16-48 user tokens, 32 new tokens each),
    the 8 turns of a round served together on a prefix-caching engine;
    then every turn's prompt replayed on a cold engine. Counters on every
    run. Returns the warm and cold requests, the warm run's ``GapProbe``,
    the hits per turn, the counted runs, ``lp`` (the largest |warm - cold|
    logprob of a token emitted before the two streams part, the same
    history on both) and ``steps`` (per layer, the largest decode-written
    (warm) vs prefill-written (cold) K/V entry of the previous turns'
    outputs, in storage steps)."""
    import torch
    from repro_torch.serving.engine import DecodeEngine, Request
    warm = DecodeEngine(cfg, params, prefix_cache=True, device=dev,
                        **SERVE_KW)
    cold = DecodeEngine(cfg, params, device=dev, **SERVE_KW)
    first, later = conversation_turns(cfg, seed)
    spans: dict = {}
    wkv: dict = {}
    ckv: dict = {}
    capture_retired(warm, spans, wkv, cut_at_hit=True)
    capture_retired(cold, spans, ckv)
    probe = GapProbe(warm)
    hist = [list(p) for p in first]
    runs, hits, all_w, all_c = [], [], [], []
    prev_len = [0] * len(first)
    for t in range(1 + len(later)):
        prompts = hist if t == 0 else [h + u for h, u in zip(hist,
                                                            later[t - 1])]
        wreqs = [Request(rid=10 * t + i, prompt=list(p), max_new_tokens=32)
                 for i, p in enumerate(prompts)]
        for i, r in enumerate(wreqs):
            # the previous turn's decode-written span (its output but
            # the pending last token), cut at the hit at retirement
            spans[r.rid] = (prev_len[i], prev_len[i] + 31) if t else (0, 0)
        runs.append(counted_run(f"session turn {t + 1} warm", warm, wreqs,
                                cfg))
        creqs = [Request(rid=r.rid, prompt=list(r.prompt), max_new_tokens=32)
                 for r in wreqs]
        runs.append(counted_run(f"session turn {t + 1} cold", cold, creqs,
                                cfg))
        hits.append([r.prefix_hit for r in wreqs])
        all_w += wreqs
        all_c += creqs
        prev_len = [len(r.prompt) for r in wreqs]
        hist = [r.prompt + r.output for r in wreqs]
    probe.detach()
    lp = 0.0
    for w, c in zip(all_w, all_c):
        for a, b, x, y in zip(w.logprobs, c.logprobs, w.output, c.output):
            if x != y:
                break
            lp = max(lp, abs(a - b))
    worst = None
    for rid, entries in wkv.items():
        d = storage_steps(entries, ckv[rid], cfg.kv_dtype)
        worst = d if worst is None else torch.maximum(worst, d)
    return dict(warm=all_w, cold=all_c, probe=probe, hits=hits, runs=runs,
                lp=lp, steps=[round(float(x), 3) for x in worst])


def phase_session(dev, kind: str, cfg, params, noise: float) -> dict:
    """Session KV at full width: ``session_pairs`` on ``SESSION_SEED``. A
    later turn's hit spans the previous turn's decode-written blocks,
    which its prefill reads: that is bitwise on neither device (the
    decode kernel and the prefill's flash attention round differently),
    so the streams are held to the cold ones under the near-tie rule with
    the larger of the verify phase's N and ``SESSION_NOISE``. Each
    reading is held to the largest of the sound runs on other seeds: the
    logprob distance before parting within ``SESSION_NOISE``, every
    layer's entries within ``SESSION_STEPS`` storage steps, and layer 0's
    within one (as the verify phase's); every later turn must hit its
    whole history."""
    t0 = time.perf_counter()
    r = session_pairs(dev, cfg, params, SESSION_SEED)
    lp, per_layer, hits = r["lp"], r["steps"], r["hits"]
    rule = max(noise, SESSION_NOISE)
    log(f"[session] near-tie noise: the larger of the verify phase's N "
        f"{noise:.4g} and SESSION_NOISE {SESSION_NOISE:.4g} (fixed, "
        f"tools/session_noise.py)")
    ties = check_streams("session", r["warm"],
                         {c.rid: c.output for c in r["cold"]}, r["probe"],
                         rule, tag="session", ref="the cold run")
    if not lp <= SESSION_NOISE:
        fail(f"session: warm vs cold logprobs part by {lp:.4g} before the "
             f"streams do, past SESSION_NOISE {SESSION_NOISE:.4g}")
    if not all(map(math.isfinite, per_layer)):
        fail(f"session: non-finite entry distance {per_layer}")
    if per_layer[0] > 1.0 or max(per_layer) > SESSION_STEPS:
        fail(f"session: decode-written vs prefill-written entries "
             f"{per_layer} storage steps (layer 0 within 1, every layer "
             f"within SESSION_STEPS {SESSION_STEPS})")
    for t, h in enumerate(hits[1:], start=2):
        if min(h) < SYS_TOKENS:
            fail(f"session: turn {t} hit {h}, not the whole history")
    out = merge_runs(r["runs"])
    log(f"[session] qwen1.5-0.5b bf16 on {kind}: 8 conversations x 3 "
        f"turns; hit tokens per turn {[sum(h) for h in hits]} (per "
        f"request {hits[1:]}); streams vs the cold replay: {ties} near-tie "
        f"divergences; max |warm - cold| logprob before any "
        f"{lp:.4g} (limit {SESSION_NOISE:.4g}); decode-written (warm) "
        f"vs prefill-written (cold) K/V entries of the previous turns' "
        f"outputs, per layer in storage steps "
        f"({STORAGE_STEP[cfg.kv_dtype]:.4g} x the row's max |value|; limit "
        f"{SESSION_STEPS}): max {max(per_layer)}, layer 0 "
        f"{per_layer[0]}, {per_layer}; warm {out['tok_s']:.3f} tok/s over "
        f"warm and cold runs; {time.perf_counter() - t0:.1f} s")
    return out


def link_rates(dev, mib: int = 256, reps: int = 10) -> tuple[float, float]:
    """Pinned host <-> device copy rates (bytes/s, CUDA-event medians) of
    one contiguous ``mib`` MiB buffer: (device -> host, host -> device)."""
    import torch
    host = torch.empty(mib << 20, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(mib << 20, dtype=torch.uint8, device=dev)
    rates = []
    for dst, src in ((host, card), (card, host)):
        times = []
        for _ in range(reps + 1):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            dst.copy_(src, non_blocking=True)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        rates.append((mib << 20) / (statistics.median(times[1:]) / 1e3))
    return rates[0], rates[1]


class SwapTimer:
    """CUDA events around each ``KVSwap.swap_out`` / ``swap_in`` of an
    engine: (bytes, ms) per direction, read after the run."""

    def __init__(self, swap):
        import torch
        self.swap = swap
        self.events = {"out": [], "in": []}
        for name, d, key in (("swap_out", "out", "host_bytes_total"),
                             ("swap_in", "in", "restored_bytes_total")):
            fn = getattr(swap, name)

            def timed(*a, fn=fn, d=d, key=key):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                before = swap.stats[key]
                s.record()
                fn(*a)
                e.record()
                self.events[d].append((s, e, swap.stats[key] - before))
            setattr(swap, name, timed)

    def rate(self, d: str) -> tuple[int, float]:
        import torch
        torch.cuda.synchronize()
        nbytes = sum(n for *_, n in self.events[d])
        ms = sum(s.elapsed_time(e) for s, e, _ in self.events[d])
        return nbytes, (nbytes / (ms / 1e3) if ms else 0.0)


def phase_preempt(dev, kind: str, cfg, params, paths: dict) -> tuple:
    """Preemption to host at full width: the serve phases' 16 requests on
    a pool of about half the blocks their 8 largest need at once, with
    ``preempt="lru"``, over bf16, int8 and fp8 pools. Every request must
    finish and its tokens and logprobs must be bitwise the serve phase's
    (restores are copies, the decode step runs all 8 rows whichever are
    live, and the attention kernel does not see block ids); nothing held
    at the end. Prints the preemptions, the snapshot bytes and the
    snapshot copy rates (CUDA events around each swap), and the pinned
    copy rates of the host link (the ``host_link_bw`` of
    ``repro_torch.ecm.machines``)."""
    from repro_torch.serving.engine import DecodeEngine
    t0 = time.perf_counter()
    d2h, h2d = link_rates(dev)
    log(f"[preempt] host link on {kind}: pinned copies of 256 MiB, CUDA "
        f"events: device -> host {d2h / 1e9:.3f} GB/s, host -> device "
        f"{h2d / 1e9:.3f} GB/s")
    out = {}
    for kvd in ("bf16", "int8", "fp8"):
        qcfg = cfg.with_(kv_dtype=kvd)
        reqs = make_requests(qcfg)
        bs = SERVE_KW["block_size"]
        needs = sorted(-(-(len(r.prompt) + 32) // bs) for r in reqs)
        pool = 1 + max(sum(needs[-8:]) // 2, needs[-1])
        engine = DecodeEngine(qcfg, params, num_blocks=pool, preempt="lru",
                              device=dev, **SERVE_KW)
        timer = SwapTimer(engine.swap)
        run = counted_run(f"preempt {kvd}", engine, reqs, qcfg)
        want = paths[f"qwen1.5-0.5b {kvd}"]
        for r in reqs:
            if r.output != want["streams"][r.rid] or \
                    r.logprobs != want["logprobs"][r.rid]:
                fail(f"preempt {kvd}: request {r.rid} is not bitwise its "
                     f"serve-phase run")
        st = engine.kv_stats
        if not st["preempted"] or len(engine.swap) or \
                engine.scheduler.allocator.num_held:
            fail(f"preempt {kvd}: {st['preempted']} preemptions, "
                 f"{len(engine.swap)} snapshots and "
                 f"{engine.scheduler.allocator.num_held} blocks held at "
                 f"the end")
        out_b, out_r = timer.rate("out")
        in_b, in_r = timer.rate("in")
        log(f"[preempt] {kvd} pools, {pool - 1} usable blocks (8 slots' "
            f"largest need {sum(needs[-8:])}): {st['preempted']} "
            f"preemptions of {st['preempted_blocks']} blocks, "
            f"{st['restored_blocks']} restored; every stream bitwise the "
            f"{kvd} serve phase's; snapshots {out_b} B out ({out_r / 1e9:.3f}"
            f" GB/s, gather + copy), {in_b} B in ({in_r / 1e9:.3f} GB/s, "
            f"copy + scatter); {run['emitted'] / run['wall']:.3f} tok/s, "
            f"median step {statistics.median(run['step_ms']):.3f} ms")
        out[kvd] = merge_runs([run])
    log(f"[preempt] {time.perf_counter() - t0:.1f} s")
    return out, h2d


def phase_spill(dev, kind: str, cfg, params, h2d: float) -> dict:
    """The session spill tier at full width: prefix caching, session KV
    and ``spill_blocks`` on a pool of 224 blocks. Turn 1 of 8
    conversations, then 8 unrelated requests of 256-400 tokens whose
    admission evicts (spills) the conversations' blocks, then turn 2,
    whose admission may promote them back. Run twice:

    - ``promote="auto"``: the H100 gate (its ratio printed, and the ratio
      the measured host link gives). With bf16 tensor-core re-prefill,
      qwen1.5-0.5b's ratio is below 1, so nothing may be promoted;
    - ``promote="always"``: blocks must be promoted, each bitwise its
      spilled snapshot.

    Every request finishes; at the end only the trie holds blocks and no
    preemption snapshot is left. Counters on every run."""
    from repro_torch.ecm.hopper import predicted_restore_vs_reprefill
    from repro_torch.ecm.machines import H100_SXM
    from repro_torch.models import api
    n_params = api.num_params(params)
    runs = []
    for mode in ("auto", "always"):
        t0 = time.perf_counter()
        engine, st, t2, checked, mode_runs = spill_run(dev, cfg, params,
                                                       mode)
        runs += mode_runs
        ratio = engine.prefix_cache.promote_ratio
        promoted = st["prefix_promoted_blocks"]
        if ratio > 1.0 and not (st["prefix_spilled_blocks"] and promoted
                                and checked == promoted):
            fail(f"spill {mode}: gate ratio {ratio:.4f} > 1, spilled "
                 f"{st['prefix_spilled_blocks']}, promoted {promoted}, "
                 f"checked {checked}")
        if ratio <= 1.0 and (promoted or checked):
            fail(f"spill {mode}: gate ratio {ratio:.4f} <= 1 but "
                 f"{promoted} blocks promoted")
        sp = engine.prefix_cache.spill.stats
        held = engine.scheduler.allocator.num_held
        gate = ""
        if mode == "auto":
            measured = predicted_restore_vs_reprefill(
                16, engine._token_bytes, 2 * n_params,
                hw=dict(H100_SXM, host_link_bw=h2d))
            gate = (f"gate ratio (re-prefill / restore, H100_SXM "
                    f"host_link_bw {H100_SXM['host_link_bw'] / 1e9:.3f} "
                    f"GB/s, bf16 tensor-core "
                    f"{H100_SXM['peak_flops'] / 1e12:.0f} TFLOP/s, "
                    f"{engine._token_bytes} B per token, {n_params} "
                    f"parameters) {ratio:.4f}; with this run's host link "
                    f"{h2d / 1e9:.3f} GB/s {measured:.4f}; ")
        log(f"[spill] qwen1.5-0.5b bf16 on {kind}, 224 usable blocks, "
            f"spill_blocks 256, promote {mode}: {gate}"
            f"{st['prefix_spilled_blocks']} blocks spilled "
            f"({st['prefix_spilled_bytes']} B), {promoted} promoted "
            f"({sp['promoted_bytes_total']} B), {checked} checked bitwise "
            f"against their snapshots; turn-2 hits "
            f"{[r.prefix_hit for r in t2]}; {sp['dropped_blocks']} "
            f"dropped by the tier's capacity; at the end {held} blocks "
            f"held, all by the trie; {time.perf_counter() - t0:.1f} s")
    return merge_runs(runs)


def spill_run(dev, cfg, params, mode: str):
    """One run of ``phase_spill`` with ``promote=mode``; returns the
    engine, its counters, the turn-2 requests, the promoted blocks
    checked bitwise, and the three counted runs."""
    import torch
    from repro_torch.models import paged
    from repro_torch.serving.engine import DecodeEngine, Request
    engine = DecodeEngine(cfg, params, prefix_cache=True, spill_blocks=256,
                          promote=mode, num_blocks=225, device=dev,
                          **SERVE_KW)
    pc = engine.prefix_cache
    taken: list = []
    take = pc.spill.take

    def recording_take(key):
        snap = take(key)
        taken.append(snap)
        return snap

    pc.spill.take = recording_take
    promote_fn = pc.promote_fn
    checked = [0]

    def checked_promote(blocks, snaps):
        promote_fn(blocks, snaps)
        want = paged.concat_block_snapshots(snaps)
        got = paged.extract_blocks(engine.caches, blocks)
        if any(not torch.equal(got[k], want[k]) for k in want) or \
                len(snaps) != len(taken):
            fail("spill: a promoted block is not bitwise its snapshot")
        taken.clear()
        checked[0] += len(blocks)

    pc.promote_fn = checked_promote
    first, later = conversation_turns(cfg, SESSION_SEED, turns=2)
    runs = []
    t1 = [Request(rid=i, prompt=list(p), max_new_tokens=32)
          for i, p in enumerate(first)]
    runs.append(counted_run(f"spill {mode} turn 1", engine, t1, cfg))
    g = torch.Generator().manual_seed(SEED + 6)
    filler = [Request(rid=100 + i, prompt=random_tokens(g, cfg, 256, 400),
                      max_new_tokens=32) for i in range(8)]
    runs.append(counted_run(f"spill {mode} filler", engine, filler, cfg))
    t2 = [Request(rid=10 + i, prompt=r.prompt + r.output + u,
                  max_new_tokens=32)
          for i, (r, u) in enumerate(zip(t1, later[0]))]
    runs.append(counted_run(f"spill {mode} turn 2", engine, t2, cfg))
    held = engine.scheduler.allocator.num_held
    if held != pc.num_nodes or len(engine.swap) or engine.num_unfinished:
        fail(f"spill {mode}: {held} blocks held by {pc.num_nodes} trie "
             f"nodes, {len(engine.swap)} snapshots, "
             f"{engine.num_unfinished} requests unfinished at the end")
    return engine, engine.kv_stats, t2, checked[0], runs


# ------------------------------------------------------------ telemetry --

def _balanced(trace) -> bool:
    opened = collections.Counter((e.rid, e.name) for e in trace.events
                                 if e.ph == "B")
    closed = collections.Counter((e.rid, e.name) for e in trace.events
                                 if e.ph == "E")
    return opened == closed


def phase_obs(dev, kind: str, cfg, params, serve: dict, flat: dict,
              h2d: float) -> dict:
    """Telemetry on the served path: the bf16 serve phase's 16 requests
    on 8 slots, three times on fresh engines:

    A. ``Telemetry(wall_clock=True, profile=True)``: the profiler counts
       each phase's launches on its first call (the warm-up);
    B. the same, its profiler A's after ``reset()`` (caches kept), so the
       attribution holds no counting time;
    C. no telemetry.

    Held: A's and B's tokens and logprobs bitwise the serve phase's; A's
    and B's trace key sequences equal and their spans balanced;
    ``metrics_snapshot()`` holding every ``kv_stats`` counter; each run's
    launch counters those of the serve phase (B1 once per layer and
    decode step, B2 twice per step and per first token). Printed: the
    profiler's calibration (B2f through ``ops.kahan_dot``) and B's
    per-phase attribution, the residual rows, and the median step of B
    (on) and C (off), with no limit on those (host noise). The trace of
    B goes to ``chiprun_out/obs_trace.json``."""
    import torch
    from repro_torch import obs
    from repro_torch.ecm import hopper
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import DecodeEngine
    t0 = time.perf_counter()
    runs, teles = {}, {}
    for label in ("A", "B", "C"):
        tele = None
        if label != "C":
            tele = obs.Telemetry(wall_clock=True, profile=True)
        if label == "B":
            tele.profile = teles["A"].profile
            tele.profile.reset()
        engine = DecodeEngine(cfg, params, device=dev, telemetry=tele,
                              **SERVE_KW)
        reqs = make_requests(cfg)
        wall, step_ms, launches = serve_run(engine, reqs)
        st = engine.kv_stats
        check_served(f"obs {label}", engine, reqs, launches,
                     {"paged_attention": cfg.num_layers * st["decode_steps"],
                      "fused_reduce": 2 * (st["decode_steps"] + len(reqs))})
        if label != "C":
            if any(r.output != serve["streams"][r.rid]
                   or r.logprobs != serve["logprobs"][r.rid] for r in reqs):
                fail(f"obs {label}: tokens or logprobs are not bitwise the "
                     f"bf16 serve phase's")
            snap = engine.metrics_snapshot()
            bad = [k for k, v in st.items() if snap.get(k) != v]
            if bad:
                fail(f"obs {label}: metrics_snapshot differs from kv_stats "
                     f"at {bad}")
            if not _balanced(tele.trace):
                fail(f"obs {label}: unbalanced spans")
            teles[label] = tele
        runs[label] = dict(launches=launches, wall=wall, step_ms=step_ms,
                           emitted=sum(len(r.output) for r in reqs),
                           engine=engine)
    keys_a = teles["A"].trace.key_sequence()
    if keys_a != teles["B"].trace.key_sequence():
        fail("obs: the trace key sequences of runs A and B differ")
    tele, prof = teles["B"], teles["B"].profile
    ops.reset_launches()
    cal = prof.calibrate()
    cal_launches = dict(ops.launches)
    engine = runs["B"]["engine"]
    log(f"[obs] qwen1.5-0.5b bf16 on {kind}, 16 requests, 8 slots, "
        f"Telemetry(wall_clock=True, profile=True): tokens and logprobs "
        f"bitwise the serve phase's (runs A, B); {len(keys_a)} trace "
        f"events, key sequences of A and B equal, spans balanced; "
        f"metrics_snapshot holds all {len(engine.kv_stats)} kv_stats "
        f"counters; launch counters {runs['B']['launches']}")
    log(f"[obs] calibration (B2f through ops.kahan_dot, "
        f"{cal_launches.get('fused_reduce', 0)} launches): "
        f"{json.dumps(cal.to_json())}")
    for line in prof.render().splitlines():
        log(f"[obs] {line}")
    log(f"[obs] counters: {prof.counter_table()}")
    # residuals
    res = tele.residuals
    res.record("kahan_overhead/b2f", hopper.kahan_overhead(),
               flat["ms"] / flat["naive_ms"], basis="wallclock",
               elems=1 << 24)
    ps = prof.phases
    pre = ps["prefill_chunk"]
    tokens = runs["B"]["engine"].kv_stats["prefill_tokens"]
    reprefill_s = pre.wall_s / tokens
    restore_s = engine._token_bytes / h2d
    res.record("restore_vs_reprefill/qwen1.5-0.5b",
               engine._promote_gate("auto"), reprefill_s / restore_s,
               basis="wallclock", reprefill_us_per_token=round(
                   1e6 * reprefill_s, 3),
               restore_us_per_token=round(1e6 * restore_s, 3))
    dec = ps["decode_step"]
    steps = engine.kv_stats["decode_steps"]
    bound_ms = 1e3 * max(dec.hbm_bytes / prof.hw["hbm_bw"],
                         dec.dot_flops / prof.hw["peak_flops"]
                         + (dec.flops - dec.dot_flops)
                         / prof.hw["f32_flops"]) / steps
    res.record("decode_step/bound_vs_device_busy", bound_ms,
               serve["profile"]["busy_ms"], basis="wallclock",
               unit="ms_per_step")
    res.record("decode_step/launches", dec.calls / steps,
               serve["profile"]["kernels"], basis="counter",
               what="LaunchCounter vs torch.profiler kernels per step")
    for row in res.rows():
        log(f"[obs] residual {row[0]}: {row[2]}")
    on = statistics.median(runs["B"]["step_ms"])
    off = statistics.median(runs["C"]["step_ms"])
    log(f"[obs] median decode step: telemetry on {on:.3f} ms, off "
        f"{off:.3f} ms (on / off {on / off:.3f}; host clock, no limit); "
        f"tok/s on {runs['B']['emitted'] / runs['B']['wall']:.3f}, off "
        f"{runs['C']['emitted'] / runs['C']['wall']:.3f}")
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    n = tele.to_chrome(out_dir / "obs_trace.json")
    log(f"[obs] Chrome trace of run B: {n} events + "
        f"{len(prof.counter_events())} counter samples -> "
        f"chiprun_out/obs_trace.json; {time.perf_counter() - t0:.1f} s")
    merged = merge_runs([runs[k] for k in ("A", "B", "C")])
    merged["calibration_launches"] = cal_launches
    torch.cuda.empty_cache()
    return merged


def report_c1(q_paths: dict, d_paths: dict) -> None:
    """The per-step numbers of the C1 repair against its prediction
    (printed, not gated): deepseek-v2 decode device busy <= 20 ms and
    peak memory < 39.6 GiB; qwen1.5 bf16 decode launches ~845 fewer than
    2947 and device busy <= 5.5 ms."""
    d = d_paths["deepseek-v2-236b"]
    q = q_paths["qwen1.5-0.5b bf16"]
    log(f"[c1] deepseek-v2 decode: device busy "
        f"{d['profile']['busy_ms']:.3f} ms/step (predicted <= 20, was "
        f"59.799), {d['profile']['kernels']:.0f} kernels/step (was 763), "
        f"peak device memory {d['peak_gib']:.2f} GiB (predicted < 39.6); "
        f"qwen1.5 bf16 decode: device busy {q['profile']['busy_ms']:.3f} "
        f"ms/step (predicted <= 5.5, was 7.728), "
        f"{q['profile']['kernels']:.0f} kernels/step (predicted ~2102, was "
        f"2947), tok/s {q['tok_s']:.3f}")


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
    from repro_torch.models import api
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
    # qwen1.5-0.5b at full width and depth: the verify window against the
    # decode steps over each pool format, the three non-spec serve paths,
    # then the two speculative ones (their streams held to the bf16 one)
    q_what = ("qwen1.5-0.5b full width (24 L, d 1024, 16 H, vocab 151936, "
              f"random weights seed {SEED})")
    q_params = api.init_params(qwen, device=dev, seed=SEED)
    wall = {}                     # seconds each phase took, host clock
    t0 = time.perf_counter()
    noise = {kvd: phase_verify_parity(dev, qwen.with_(kv_dtype=kvd),
                                      q_params, "qwen1.5-0.5b")
             for kvd in ("bf16", "int8", "fp8")}
    wall["qwen1.5-0.5b verify x3"] = time.perf_counter() - t0
    q_paths = {}
    for kvd in ("bf16", "int8", "fp8"):
        t0 = time.perf_counter()
        q_paths[f"qwen1.5-0.5b {kvd}"] = phase_serve(
            dev, kind, qwen.with_(kv_dtype=kvd), q_what, q_params)
        wall[f"qwen1.5-0.5b {kvd}"] = time.perf_counter() - t0
    base = q_paths["qwen1.5-0.5b bf16"]["streams"]
    t0 = time.perf_counter()
    q_paths["qwen1.5-0.5b spec n-gram"] = phase_spec(
        dev, kind, qwen, q_what, q_params, "ngram", VERIFY_K, base=base,
        noise=noise["bf16"], profile=True)
    wall["qwen1.5-0.5b spec n-gram"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_paths["qwen1.5-0.5b spec self-draft"] = phase_spec(
        dev, kind, qwen, q_what, q_params, "draft", DRAFT_K, base=base,
        noise=noise["bf16"])
    wall["qwen1.5-0.5b spec self-draft"] = time.perf_counter() - t0
    # keyed RNG, sampled serving and speculation, fault injection with
    # failover, on the same weights
    t0 = time.perf_counter()
    gumbel_eps = phase_rng(dev)
    phase_sample(dev, gumbel_eps)
    wall["rng + sample"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_paths["qwen1.5-0.5b sampled"] = phase_serve_sampled(
        dev, kind, qwen, q_what, q_params, base,
        q_paths["qwen1.5-0.5b bf16"]["profile"])
    wall["qwen1.5-0.5b sampled"] = time.perf_counter() - t0
    for proposer, k in (("n-gram", VERIFY_K), ("self-draft", DRAFT_K)):
        t0 = time.perf_counter()
        q_paths[f"qwen1.5-0.5b sampled spec {proposer}"] = \
            phase_spec_sampled(dev, kind, qwen, q_what, q_params,
                               "ngram" if proposer == "n-gram" else "draft",
                               k)
        wall[f"qwen1.5-0.5b sampled spec {proposer}"] = \
            time.perf_counter() - t0
    t0 = time.perf_counter()
    (q_paths["qwen1.5-0.5b faults"],
     q_paths["qwen1.5-0.5b spec proposer stalls"]) = phase_faults(
        dev, kind, qwen, q_params, base, noise["bf16"])
    wall["qwen1.5-0.5b faults"] = time.perf_counter() - t0
    # prefix caching, session KV, preemption to host and the spill tier
    t0 = time.perf_counter()
    q_paths["qwen1.5-0.5b prefix"] = phase_prefix(dev, kind, qwen, q_params,
                                                  noise["bf16"])
    wall["qwen1.5-0.5b prefix"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_paths["qwen1.5-0.5b session"] = phase_session(dev, kind, qwen,
                                                    q_params, noise["bf16"])
    wall["qwen1.5-0.5b session"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    preempted, h2d = phase_preempt(dev, kind, qwen, q_params, q_paths)
    for kvd, r in preempted.items():
        q_paths[f"qwen1.5-0.5b preempt {kvd}"] = r
    wall["qwen1.5-0.5b preempt x3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_paths["qwen1.5-0.5b spill"] = phase_spill(dev, kind, qwen, q_params,
                                                h2d)
    wall["qwen1.5-0.5b spill"] = time.perf_counter() - t0
    # telemetry and the ECM attribution profiler on the bf16 serve path
    t0 = time.perf_counter()
    q_paths["qwen1.5-0.5b obs"] = phase_obs(
        dev, kind, qwen, q_params, q_paths["qwen1.5-0.5b bf16"],
        times["fused_reduce_flat"], h2d)
    wall["qwen1.5-0.5b obs"] = time.perf_counter() - t0
    del q_params
    torch.cuda.empty_cache()
    # deepseek-v2 at full width, depth cut to 3 (1 dense + 2 MoE layers):
    # 60 layers are 236 B parameters; 3 layers are ~9.3 B: 15.3 GiB held
    # as bf16 and 4.1 GiB of f32 norms, embeddings and LM head.
    # Its weights are built once for the serve path, the verify window and
    # the speculative path (no stream equality: MoE capacity routing
    # depends on which tokens share a call)
    ds = get_config("deepseek-v2-236b").with_(num_layers=3)
    d_what = ("deepseek-v2-236b full width, 3 L (1 dense + 2 MoE; d 5120, "
              "MLA 128 H kv_lora 512 rope 64, 160 experts top-6 + 2 shared, "
              f"vocab 102400; random weights seed {SEED})")
    d_params = api.init_params(ds, device=dev, seed=SEED)
    t0 = time.perf_counter()
    d_paths = {"deepseek-v2-236b": phase_serve(dev, kind, ds, d_what,
                                               d_params)}
    wall["deepseek-v2-236b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    noise["deepseek-v2-236b"] = phase_verify_parity(dev, ds, d_params,
                                                    "deepseek-v2-236b 3 L")
    wall["deepseek-v2-236b verify"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_paths["deepseek-v2-236b spec n-gram"] = phase_spec(
        dev, kind, ds, d_what, d_params, "ngram", VERIFY_K)
    wall["deepseek-v2-236b spec n-gram"] = time.perf_counter() - t0
    del d_params
    torch.cuda.empty_cache()
    report_c1(q_paths, d_paths)

    def by_path(paths, name):
        return {k: v["launches"][name] for k, v in paths.items()}

    spec_paths = ("qwen1.5-0.5b spec n-gram", "qwen1.5-0.5b spec self-draft",
                  "qwen1.5-0.5b sampled spec n-gram",
                  "qwen1.5-0.5b sampled spec self-draft",
                  "qwen1.5-0.5b spec proposer stalls")
    pa_by = by_path(q_paths, "paged_attention")
    lat_by = by_path(d_paths, "paged_latent_attention")
    red_by = {**by_path(q_paths, "fused_reduce"),
              **by_path(d_paths, "fused_reduce"),
              "flat entry points": k_launch["fused_reduce"],
              "obs calibration": q_paths["qwen1.5-0.5b obs"][
                  "calibration_launches"]["fused_reduce"]}
    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:307",
             launches=sum(pa_by.values()), launches_by_path=pa_by,
             max_abs_err=attn_err, **times["paged_attention"],
             verify=dict(launches=sum(pa_by[p] for p in spec_paths),
                         **times["paged_attention_verify"])),
        dict(name="fused_reduce", route="cuda",
             source="src/repro_torch/csrc/fused_reduce.cu",
             replaces="src/repro/kernels/engine.py:327",
             launches=sum(red_by.values()), launches_by_path=red_by,
             max_abs_err=red_err, **times["fused_reduce"],
             verify=dict(launches=sum(red_by[p] for p in spec_paths)
                         + red_by["deepseek-v2-236b spec n-gram"],
                         **times["fused_reduce_verify"]),
             flat=dict(replaces="src/repro/kernels/engine.py:282",
                       max_abs_err=flat_err, **times["fused_reduce_flat"])),
        dict(name="paged_latent_attention", route="cuda",
             source="src/repro_torch/csrc/paged_latent_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:354",
             launches=sum(lat_by.values()), launches_by_path=lat_by,
             max_abs_err=lat_err, **times["paged_latent_attention"],
             verify=dict(launches=lat_by["deepseek-v2-236b spec n-gram"],
                         **times["paged_latent_attention_verify"])),
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
    for name, r in {**q_paths, **d_paths}.items():
        extra = "" if "acceptance" not in r else (
            f", acceptance rate {r['acceptance']:.4f}, mean accepted length "
            f"{r['accepted_len']:.4f}, near-tie divergences {r['ties']}")
        log(f"[serve] {name}: tok/s {r['tok_s']:.3f}, median step "
            f"{r['step_ms']:.3f} ms{extra}")
    log(f"[verify] formulation noise N (max |verify - decode| logits): "
        f"{noise}")
    log(f"[serve] seconds per phase, profile windows included: "
        f"{ {k: round(v, 1) for k, v in wall.items()} }")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
