"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``
(twin of ``repro.launch.serve``) — random-weight continuous-batching
demo of the paged-KV decode engine on one device: ``--device cuda`` (the
default) or ``--device cpu``, the port's one flag of its own. ``--spec-mode`` switches
on speculative decoding (n-gram prompt-lookup or a draft model from the
registry); ``--session-kv`` serves multi-turn conversations against the
session prefix tier (whole-history trie hits, evicted prefixes spilled
to host and promoted back — pair with a tight ``--num-blocks`` to watch
the spill/promote path); ``--preempt``/``--deadline-steps`` exercise the
fault-tolerance layer (preemption-to-host, request deadlines), and
``--faults`` runs the
deterministic fault-injection smoke used by CI: every applicable injector
site fires once and the engine must finish all surviving requests.
Invalid combinations are rejected with a clear error before any model is
built; Ctrl-C triggers the ``--shutdown`` policy (drain or cancel).

Configs are reduced (``configs.reduced``), as in the reference. The
weights come from a seeded ``torch.Generator`` (``api.init_params``, seed
0; the draft model's seed 1), not from ``jax.random.key(0)``, so the
token streams differ from the reference CLI's; every flag, default,
choice and refusal is the reference's."""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs
from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.models import api
from repro_torch.serving.engine import (DecodeEngine, Request,
                                        SpecDecodeEngine)
from repro_torch.serving.faults import (FailoverServer, FaultInjector,
                                        FaultSpec, StallError)

SPEC_FAMILIES = ("dense", "moe", "vlm")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=sorted(REGISTRY))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-context", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=("bf16", "int8", "fp8"),
                    help="KV-cache pool precision (repro_torch.quant): quantized "
                         "pools carry per-(token, head) scale tiles and cut "
                         "KV bytes/token ~2x")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-cache shared prompt prefixes over the paged "
                         "block pool (refcounted blocks, copy-on-write at "
                         "the divergence block, LRU eviction); the demo "
                         "requests then share a system prompt so the hit "
                         "rate is visible")
    ap.add_argument("--session-kv", action="store_true",
                    help="multi-turn session demo: implies --prefix-cache, "
                         "arms the host spill tier for evicted prefixes "
                         "(--spill-blocks), and serves --turns conversation "
                         "turns per request — each later turn's prompt is "
                         "the full prior history plus fresh tokens, so it "
                         "hits the whole-history trie entry (or promotes it "
                         "back from host). Combine with a tight "
                         "--num-blocks to force evict -> spill -> promote")
    ap.add_argument("--turns", type=int, default=3,
                    help="conversation turns per request under "
                         "--session-kv (default 3)")
    ap.add_argument("--spill-blocks", type=int, default=32,
                    help="host spill-tier capacity in blocks under "
                         "--session-kv (LRU beyond this; default 32)")
    ap.add_argument("--promote", default="always",
                    choices=("auto", "always", "never"),
                    help="gate for promoting host-spilled prefixes back "
                         "into the pool: 'auto' applies the ECM "
                         "restore-vs-reprefill crossover (demo-sized "
                         "models sit below it, so the demo defaults to "
                         "'always'); 'never' falls back to cold prefill")
    ap.add_argument("--spec-mode", default="off",
                    choices=("off", "ngram", "draft"),
                    help="speculative decoding: 'ngram' proposes from the "
                         "request's own context (no extra model), 'draft' "
                         "runs --draft-arch as the proposer")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft tokens verified per step (requires a "
                         "--spec-mode other than 'off'; default 4)")
    ap.add_argument("--draft-arch", default=None,
                    choices=sorted(REGISTRY),
                    help="registry config drafting for the target "
                         "(required by --spec-mode draft)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="override the KV block-pool size (default: enough "
                         "for max_slots full contexts); small pools plus "
                         "--preempt demonstrate swap-out under pressure")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="retire any request still unfinished this many "
                         "engine steps after submission (partial output is "
                         "kept, state == 'expired')")
    ap.add_argument("--preempt", default="off",
                    choices=("off", "lru", "priority"),
                    help="under pool pressure, swap a victim's KV blocks "
                         "to host (repro_torch.serving.swap) so the head of the "
                         "queue can admit; restored requests resume "
                         "bitwise identically")
    ap.add_argument("--shutdown", default="drain",
                    choices=("drain", "cancel"),
                    help="Ctrl-C policy: 'drain' finishes in-flight "
                         "requests (no new admissions), 'cancel' retires "
                         "them immediately with partial output")
    ap.add_argument("--faults", action="store_true",
                    help="deterministic fault-injection smoke: arm every "
                         "applicable injector site once (kv_corrupt, "
                         "logit_nan, alloc_fail, + proposer_stall under "
                         "--spec-mode), serve through a FailoverServer, "
                         "and require all surviving requests to finish")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="FaultInjector seed (replays bit-for-bit)")
    ap.add_argument("--max-steps", type=int, default=10_000,
                    help="StallError watchdog for the serve loop")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the engine's metrics snapshot after the "
                         "run: Prometheus text exposition if PATH ends in "
                         ".prom/.txt, JSON otherwise (the snapshot "
                         "contains every kv_stats counter verbatim plus "
                         "derived gauges and latency histograms)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-request lifecycle tracing on the "
                         "engine-step clock and write it after the run: "
                         "JSONL if PATH ends in .jsonl, Perfetto-loadable "
                         "Chrome trace JSON otherwise")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="ECM attribution profiling: calibrate the "
                         "pinned Kahan-dot reference at start, account "
                         "every engine phase's wall time into compute/"
                         "HBM/host/dispatch/unattributed from its "
                         "compiled-HLO cost, write the attribution JSON "
                         "to PATH and print the rendered table; with "
                         "--trace, ECM counter tracks are appended to "
                         "the Chrome trace")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: 'cuda' (the card, the "
                         "default) or 'cpu' (the plain PyTorch path)")
    return ap


def validate_session_args(args, cfg) -> None:
    """Reject invalid session-KV combinations before building."""
    if not args.session_kv:
        return
    if cfg.family == "ssm":
        raise SystemExit(
            f"--session-kv: {args.arch} is an 'ssm'-family model with "
            f"constant-size recurrent state — there are no per-token KV "
            f"blocks to cache across turns")
    if args.turns < 2:
        raise SystemExit(f"--turns must be >= 2, got {args.turns}")
    if args.spill_blocks < 1:
        raise SystemExit(
            f"--spill-blocks must be >= 1, got {args.spill_blocks}")


def validate_fault_args(args, cfg) -> None:
    """Reject invalid fault-tolerance combinations before building."""
    if args.deadline_steps is not None and args.deadline_steps < 1:
        raise SystemExit(
            f"--deadline-steps must be >= 1, got {args.deadline_steps}")
    if args.max_steps < 1:
        raise SystemExit(f"--max-steps must be >= 1, got {args.max_steps}")
    if args.num_blocks is not None and args.num_blocks < 2:
        raise SystemExit(
            f"--num-blocks must be >= 2 (null block + capacity), "
            f"got {args.num_blocks}")
    if args.preempt != "off" and cfg.family == "ssm":
        raise SystemExit(
            f"--preempt {args.preempt}: {args.arch} is an 'ssm'-family "
            f"model with constant-size recurrent state — there are no "
            f"per-token KV blocks to swap to host")
    if args.faults and cfg.family == "ssm":
        raise SystemExit(
            "--faults: the injection sites target paged-KV serving "
            "(kv_corrupt poisons pool blocks); pick an attention-family "
            "--arch")


def validate_spec_args(args, cfg) -> None:
    """Reject invalid speculative-serving combinations with a clear
    message instead of a traceback deep in the engine."""
    if args.spec_mode == "off":
        if args.spec_k is not None:
            raise SystemExit(
                "--spec-k only applies to speculative serving; pass "
                "--spec-mode ngram|draft (or drop --spec-k)")
        if args.draft_arch is not None:
            raise SystemExit(
                "--draft-arch only applies to --spec-mode draft")
        return
    if cfg.family not in SPEC_FAMILIES:
        raise SystemExit(
            f"--spec-mode {args.spec_mode}: {args.arch} is a "
            f"{cfg.family!r}-family model whose recurrent state cannot be "
            f"rolled back after a rejected draft; speculative serving "
            f"needs a paged-KV attention family {SPEC_FAMILIES}")
    if args.spec_k is not None and args.spec_k < 1:
        raise SystemExit(f"--spec-k must be >= 1, got {args.spec_k}")
    if args.spec_mode == "draft":
        if args.draft_arch is None:
            raise SystemExit(
                "--spec-mode draft needs a draft config: pass "
                "--draft-arch <id> (e.g. --draft-arch qwen1.5-0.5b "
                "drafting for a larger target)")
        draft_cfg = get_config(args.draft_arch)
        if draft_cfg.family not in ("dense", "moe"):
            raise SystemExit(
                f"--draft-arch {args.draft_arch}: {draft_cfg.family!r}-"
                f"family models cannot draft (rollback needs a paged KV "
                f"cache); pick a dense/moe config")
    elif args.draft_arch is not None:
        raise SystemExit("--draft-arch only applies to --spec-mode draft")


def _summary_line(args, snap: dict, n_done: int, total: int,
                  dt: float, turn2_hit: int = 0,
                  turn2_hist: int = 0) -> str:
    """Render the final summary from a metrics snapshot — every number
    here is a snapshot entry, so the line, the ``--metrics`` export and
    the bench counters can never disagree."""
    line = (f"{n_done} requests, {total} tokens in {dt:.1f}s "
            f"({total/dt:.1f} tok/s, {args.slots} slots, "
            f"{args.device.upper()})")
    if snap["paged_bytes"]:
        ratio = snap["contiguous_bytes"] / snap["paged_bytes"]
        line += (f" | KV touched {snap['paged_bytes']/2**20:.1f} MiB paged "
                 f"vs {snap['contiguous_bytes']/2**20:.1f} MiB contiguous "
                 f"({ratio:.1f}x less)")
        if args.kv_dtype != "bf16":
            qratio = snap["paged_bytes_bf16"] / snap["paged_bytes"]
            line += (f" | {args.kv_dtype} KV {qratio:.2f}x fewer bytes "
                     f"than bf16 pools")
    else:   # ssm family: constant-size state, no per-token KV to page
        line += " | constant-state family (no per-token KV)"
    if args.prefix_cache:
        line += (f" | prefix cache hit {snap['prefix_hit_rate']:.0%} "
                 f"({snap['prefix_hit_tokens']} tok, "
                 f"{snap['prefix_saved_bytes']/2**20:.2f} MiB KV never "
                 f"re-prefilled)")
    if args.session_kv:
        rate = turn2_hit / turn2_hist if turn2_hist else 0.0
        line += (f" | session[{args.turns} turns] whole-history hit "
                 f"{rate:.0%} on turns>=2; spilled "
                 f"{snap['prefix_spilled_blocks']} blocks to host, "
                 f"promoted {snap['prefix_promoted_blocks']} back "
                 f"({snap['prefix_promoted_tokens']} tok never "
                 f"re-prefilled)")
    if args.spec_mode != "off":
        line += (f" | spec[{args.spec_mode}] accept "
                 f"{snap['acceptance_rate']:.0%}, "
                 f"{snap['mean_accepted_length']:.2f} tok/verify-walk")
    if args.preempt != "off" or snap["preempted"]:
        line += (f" | preempted {snap['preempted']} "
                 f"(restored {snap['restored_blocks']} blocks, "
                 f"{snap['preempted_blocks']} swapped to host)")
    if snap["cancelled"] or snap["expired"]:
        line += (f" | cancelled {snap['cancelled']}, "
                 f"expired {snap['expired']}")
    return line


def main(argv: list[str] | None = None) -> dict:
    """Serve the demo requests; returns the engine's metrics snapshot."""
    args = build_parser().parse_args(argv)

    cfg = reduced(get_config(args.arch))
    if cfg.family not in ("dense", "moe", "ssm", "vlm"):
        raise SystemExit(f"engine serves LM families; {cfg.family} uses the "
                         f"prefill/decode API directly (see repro.models.api)")
    validate_session_args(args, cfg)
    if args.session_kv:
        args.prefix_cache = True    # the session tier lives in the trie
    if args.prefix_cache and cfg.family == "ssm":
        raise SystemExit(
            f"--prefix-cache: {args.arch} is an 'ssm'-family model with "
            f"constant-size recurrent state — there are no per-token KV "
            f"blocks to share")
    validate_spec_args(args, cfg)
    validate_fault_args(args, cfg)
    if cfg.family == "vlm":
        cfg = cfg.with_(vlm=None, family="dense")   # text-only serving demo
    cfg = cfg.with_(kv_dtype=args.kv_dtype)
    params = api.init_params(cfg, device=args.device, seed=0)

    injector = None
    if args.faults:
        sites = ["kv_corrupt", "logit_nan", "alloc_fail"]
        if args.spec_mode != "off":
            sites.append("proposer_stall")
        injector = FaultInjector(args.fault_seed,
                                 [FaultSpec(site=s) for s in sites])

    # telemetry only when asked for: the default engine keeps the
    # zero-overhead NULL recorder. Wall-clock annotation is on here —
    # this is live serving, not a determinism test.
    telemetry = (obs.Telemetry(wall_clock=True,
                               profile=args.profile is not None)
                 if (args.metrics or args.trace or args.profile) else None)
    if args.profile:
        # calibrate at profiler start: the pinned reference anchors the
        # attribution and reports this host's drift against the
        # committed constant up front
        cal = telemetry.profile.calibrate(device=args.device)
        print(f"profile: kahan_dot ref {cal.ref_s * 1e6:.0f} us, "
              f"host_drift_factor {cal.host_drift_factor:.3f}")

    engine_kw: dict = dict(max_slots=args.slots,
                           max_context=args.max_context,
                           block_size=args.block_size,
                           num_blocks=args.num_blocks,
                           prefill_chunk=args.prefill_chunk,
                           prefix_cache=args.prefix_cache,
                           spill_blocks=(args.spill_blocks
                                         if args.session_kv else 0),
                           promote=args.promote,
                           preempt=args.preempt,
                           fault_injector=injector,
                           telemetry=telemetry, device=args.device)
    if args.spec_mode == "off":
        engine = DecodeEngine(cfg, params, **engine_kw)
    else:
        from repro_torch.spec import DraftModelProposer, NGramProposer
        if args.spec_mode == "ngram":
            proposer = NGramProposer()
        else:
            draft_cfg = reduced(get_config(args.draft_arch)).with_(
                kv_dtype=args.kv_dtype,
                vocab_size=cfg.vocab_size, tie_embeddings=cfg.tie_embeddings)
            draft_params = api.init_params(draft_cfg, device=args.device,
                                           seed=1)
            proposer = DraftModelProposer(draft_cfg, draft_params)
        engine = SpecDecodeEngine(cfg, params, proposer=proposer,
                                  spec_k=args.spec_k or 4, **engine_kw)

    rng = np.random.default_rng(0)
    # with --prefix-cache the demo requests share a system prompt (two
    # full blocks at the default block size) so the radix trie has real
    # prefixes to hit; without it, short unique prompts as before
    system = (rng.integers(0, cfg.vocab_size,
                           2 * args.block_size).tolist()
              if args.prefix_cache else [])
    requests = [Request(rid=i,
                        prompt=system
                        + rng.integers(0, cfg.vocab_size, 4).tolist(),
                        max_new_tokens=args.max_new,
                        eos_id=int(rng.integers(0, cfg.vocab_size)),
                        deadline_steps=args.deadline_steps)
                for i in range(args.requests)]
    server = FailoverServer(engine) if args.faults else engine
    t0 = time.time()
    turn2_hit = turn2_hist = 0
    try:
        for req in requests:    # queue everything; admission is the engine's
            server.submit(req)
        server.run_until_done(max_steps=args.max_steps)
        prev = requests
        for turn in range(1, args.turns if args.session_kv else 1):
            # each later turn's prompt is the FULL prior history (prompt
            # + emitted output) plus fresh user tokens — the whole-history
            # hit the session tier exists to serve (promoted back from
            # host when the pool evicted it meanwhile)
            followups = []
            for r in prev:
                if not r.output:
                    continue
                hist = list(r.prompt) + list(r.output)
                followups.append(Request(
                    rid=1000 * turn + (r.rid % 1000),
                    prompt=hist
                    + rng.integers(0, cfg.vocab_size, 4).tolist(),
                    max_new_tokens=args.max_new,
                    deadline_steps=args.deadline_steps))
                turn2_hist += len(hist)
            for req in followups:
                server.submit(req)
            server.run_until_done(max_steps=args.max_steps)
            turn2_hit += sum(r.prefix_hit for r in followups)
            requests = requests + followups
            prev = followups
    except KeyboardInterrupt:
        # --shutdown policy: drain finishes what is in flight (the queue
        # keeps admitting only already-submitted work — exactly the loop
        # below), cancel retires everything now with partial output.
        if args.shutdown == "cancel":
            n = engine.cancel_all()
            if args.faults and server.degraded is not None:
                n += server.degraded.cancel_all()
            print(f"shutdown: cancelled {n} in-flight requests")
        else:
            print(f"shutdown: draining "
                  f"{server.num_unfinished} in-flight requests")
            server.run_until_done(max_steps=args.max_steps)
    except StallError as e:
        raise SystemExit(f"stalled: {e}; diagnostics: {e.diagnostics}")
    dt = time.time() - t0
    done = [r for r in requests if r.done]
    if not (args.deadline_steps or args.shutdown == "cancel"):
        survivors = [r for r in requests if r.state != "failed"]
        assert len(done) == len(survivors), \
            "engine finished with pending work"
    # EOS can retire a request early — count the tokens actually emitted,
    # not requests × max_new.
    total = sum(len(r.output) for r in done)
    # one source of truth for the summary: the metrics snapshot (which
    # subsumes kv_stats value-for-value and carries the derived rates)
    snap = engine.metrics_snapshot()
    print(_summary_line(args, snap, len(done), total, dt,
                        turn2_hit=turn2_hit, turn2_hist=turn2_hist))

    if args.metrics:
        if args.metrics.endswith((".prom", ".txt")):
            with open(args.metrics, "w") as f:
                f.write(engine.metrics_prometheus())
        else:
            import json
            with open(args.metrics, "w") as f:
                json.dump(snap, f, indent=1, sort_keys=True)
        print(f"metrics: wrote {args.metrics}")
    if args.trace:
        # telemetry.to_chrome appends the profiler's ECM counter tracks
        # when --profile is also on (they never enter the event list)
        n = (telemetry.trace.to_jsonl(args.trace)
             if args.trace.endswith(".jsonl")
             else telemetry.to_chrome(args.trace))
        print(f"trace: wrote {n} events to {args.trace}")
    if args.profile:
        telemetry.profile.to_json(args.profile)
        print(telemetry.profile.render())
        print(f"profile: wrote attribution to {args.profile}")

    if args.faults:
        fired = sorted({site for _, site, _ in injector.log})
        armed = sorted(f.site for f in injector.faults)
        print(f"faults: armed {armed}, fired {fired} "
              f"(log: {injector.log})")
        print(f"faults: guard_trips={snap['guard_trips']} "
              f"alloc_faults={snap['alloc_faults']} "
              f"retried={len(server.retried)} failed={len(server.failed)}")
        if fired != armed:
            raise SystemExit(f"fault smoke: armed sites {armed} did not "
                             f"all fire (fired {fired})")
        unfinished = [r.rid for r in requests
                      if not r.done and r.state != "failed"]
        if unfinished:
            raise SystemExit(f"fault smoke: surviving requests "
                             f"{unfinished} never finished")
        print("faults: all armed sites fired once; every surviving "
              "request finished")
    return snap


if __name__ == "__main__":
    main()
