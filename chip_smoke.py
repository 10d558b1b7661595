"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device  — the card's name and ``nvidia-smi`` name / power limit;
2. build   — compiles ``src/repro_torch/csrc/*.cu`` (one nvcc each, in
             parallel) into ``build/kernels``;
3. parity  — each CUDA kernel against its plain PyTorch twin on the card
             at main-path shapes, with the tolerance and its reason;
4. times   — CUDA-event medians (L2 flushed before each launch) of each
             kernel, its plain twin and a library yardstick, beside the
             least time the card could take (HBM 3.35 TB/s, f32 CUDA-core
             67 TFLOP/s; H100 SXM data sheet);
5. small   — a reduced qwen1.5 model served on the card and on the CPU
             (plain twins) from the same weights: logits agree;
6. serve   — full-width qwen1.5-0.5b (24 layers, random seeded weights)
             behind ``DecodeEngine``: 8 slots, 16 requests of 64-512
             prompt tokens, 32 new tokens each; launch counters must
             match the decode-step count.

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


def phase_reduce_parity(dev) -> float:
    import torch
    from repro_torch.kernels import engine
    eps = 2.0 ** -24
    g = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn((8, 151936), generator=g, device=dev) * 4.0 + 1.0)
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
                log(f"[parity] fused_reduce {o}: exact {ok}")
                if not ok:
                    fail("fused_reduce max")
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
                nsplit, seg = engine.splits(8, 151936)
                depth = seg / 256 + 8 + nsplit.bit_length() + 8
                tol = depth * eps * terms.sum(1)
                why = f"{depth:.0f} eps sum|x| (naive: summation depth)"
            ek = (k.double() - exact).abs()
            ep = (p.double() - exact).abs()
            worst = max(worst, float((k.double() - p.double()).abs().max()))
            ok = bool((ek <= tol).all() and (ep <= tol).all())
            log(f"[parity] fused_reduce {o} compensated={comp}: "
                f"max|kernel-exact| {float(ek.max()):.3g}, "
                f"max|plain-exact| {float(ep.max()):.3g}, tol {why} "
                f"(max {float(tol.max()):.3g}): {ok}")
            if not ok:
                fail(f"fused_reduce {o} compensated={comp}")
    worst = max(worst, ill_conditioned_reduce(dev, g))
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


def ill_conditioned_reduce(dev, g) -> float:
    """[8, 151936] rows of +-a pairs (|a| ~ 1e6) that cancel exactly plus
    N/3 unit normals, shuffled: sum|x| ~ 8e10 against sums of a few
    hundred. A naive f32 sum loses the small terms under the big partial
    sums (errors of order 10-100); compensation keeps them. The
    compensated kernel must meet the compensated bound and the naive one
    must miss it by 10x, or the check could not tell a kernel that lost
    its carry from one that kept it. Exact sums: ``math.fsum``."""
    import math
    import torch
    from repro_torch.kernels import engine
    eps = 2.0 ** -24
    b, n = 8, 151936
    third = n // 3
    a = torch.randn((b, third), generator=g, device=dev) * 1e6
    small = torch.randn((b, n - 2 * third), generator=g, device=dev)
    x = torch.cat([a, -a, small], dim=1)
    perm = torch.argsort(torch.rand((b, n), generator=g, device=dev), dim=1)
    x = torch.gather(x, 1, perm).contiguous()
    ones = torch.ones_like(x)          # dot with ones: exact products
    rows = x.double().cpu()
    exact = torch.tensor([math.fsum(r) for r in rows.tolist()],
                         dtype=torch.float64)
    tol = 2 * eps * 2 * exact.abs() + 8 * eps ** 2 * rows.abs().sum(1)
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
            log(f"[parity] fused_reduce ill-conditioned {o} "
                f"compensated={comp}: |kernel-exact| {float(ek.min()):.3g}-"
                f"{float(ek.max()):.3g}, |plain-exact| {float(ep.min()):.3g}-"
                f"{float(ep.max()):.3g}, compensated bound 2 ulp + 8 eps^2 "
                f"sum|x| (max {float(tol.max()):.3g}), {what}: {ok}")
            if not ok:
                fail(f"fused_reduce ill-conditioned {o} compensated={comp}")
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
    return out


def phase_small(dev):
    """Reduced qwen1.5 served on the card and on the CPU from the same
    weights: the same prompt, teacher-forced, logits agree."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import api, paged
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(vocab_size=512,
                                                     num_kv_heads=2)
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
    # f32 summation order differs (cuBLAS and the kernels vs the CPU's
    # GEMMs and plain twins); at this seed no bf16 intermediate flips, and
    # the measured difference on an H100 is 1.19e-06, so ~8x that: a
    # bf16 flip (a jump of order 1e-2) fails the check
    tol = 1e-5
    log(f"[small] reduced qwen1.5 (2 layers, d=64, vocab 512) card vs CPU, "
        f"prefill 37 + 6 decode steps: max|logit diff| {worst:.4g} "
        f"(tol {tol}: f32 summation order, no bf16 flip); tokens {toks}")
    if not worst <= tol:
        fail("card and CPU disagree on the reduced model")


def phase_serve(dev, kind: str):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serving.engine import DecodeEngine, Request
    cfg = get_config("qwen1.5-0.5b")
    t0 = time.perf_counter()
    params = api.init_params(cfg, device=dev, seed=SEED)
    engine = DecodeEngine(cfg, params, max_slots=8, max_context=1024,
                          block_size=16, prefill_chunk=256, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = torch.Generator().manual_seed(SEED)
    reqs = []
    for i in range(16):
        n = int(torch.randint(64, 513, (1,), generator=rng))
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=rng)
        reqs.append(Request(rid=i, prompt=prompt.tolist(),
                            max_new_tokens=32))
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
    st = engine.kv_stats
    emitted = sum(len(r.output) for r in reqs)
    log(f"[serve] qwen1.5-0.5b full width (24 L, d 1024, 16 H, vocab "
        f"151936, random weights seed {SEED}) on {kind}: 16 requests, "
        f"prompts {min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, {emitted} tokens "
        f"emitted in {wall:.3f} s = {emitted / wall:.2f} tok/s; "
        f"{st['decode_steps']} decode steps, median step "
        f"{step_med:.3f} ms; {st['prefill_chunks']} "
        f"prefill chunks; set-up {setup_s:.2f} s")
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
    want_pa = cfg.num_layers * st["decode_steps"]
    want_fr = 2 * (st["decode_steps"] + len(reqs))
    if launches["paged_attention"] != want_pa or \
            launches["fused_reduce"] != want_fr:
        fail(f"launch counters {launches} != paged_attention {want_pa}, "
             f"fused_reduce {want_fr}")
    profile_decode(engine, cfg)
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
    log(f"[profile] decode window, {n_steps} steps x 8 slots: wall "
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
    dev = torch.device("cuda")
    _device.set_numerics()
    kind, _ = phase_device()
    phase_build()
    attn_err = phase_attention_parity(dev)
    red_err = phase_reduce_parity(dev)
    times = phase_times(dev)
    phase_small(dev)
    launches, tok_s, step_ms = phase_serve(dev, kind)
    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:307",
             launches=launches["paged_attention"], max_abs_err=attn_err,
             **times["paged_attention"]),
        dict(name="fused_reduce", route="cuda",
             source="src/repro_torch/csrc/fused_reduce.cu",
             replaces="src/repro/kernels/engine.py:327",
             also_replaces="src/repro/kernels/engine.py:282",
             launches=launches["fused_reduce"], max_abs_err=red_err,
             **times["fused_reduce"]),
    ]
    log(f"[serve] tok/s {tok_s:.3f}, median decode step {step_ms:.3f} ms")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
