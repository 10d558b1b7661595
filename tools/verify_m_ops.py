"""Which op makes a served row depend on how many rows share its call?

    python3 tools/verify_m_ops.py [--case decode|ssm-prefill|cow-prefill|
                                          oneshot]
                                  [--arch qwen1.5-0.5b|deepseek-v2-236b]
                                  [--kv-dtype bf16] [--out PATH]

``--case decode`` (the default): ``chip_smoke.py``'s verify phase
measures N, the largest logit distance between the speculative verify
window (its products at M = 8 slots x 5 rows = 40) and the decode steps
it replaces (M = 8), and shows that the window is bitwise the same
decode steps run at M = 40. So N is the decode step's dependence on M.
On qwen1.5-0.5b at full width (or ``--arch deepseek-v2-236b``, full
width cut to chip_smoke's 3 layers; random weights of ``chip_smoke.SEED``),
8 slots are prefilled with the verify phase's prompts; then one decode
step runs twice on copies of that cache, at M = 8 and at M = 40 (slots
8-39 idle on the null block).

``--case ssm-prefill``: ``chip_smoke.py``'s ``[ssm]`` phase compares the
greedy streams of mamba2-780m served at prefill chunk 256 and 64. Here
one 256-token prompt is prefilled at full width in one chunk and in four
chunks of 64, with the SSD chunk at the config's 256 and pinned to 64
(``SSMConfig.chunk``, the dual form's block): with it pinned, the two
runs make the same SSD arithmetic, so what still differs is the rows
each product and norm is called with.

``--case cow-prefill``: ``chip_smoke.py``'s ``[prefix]`` phase holds a
copy-on-write prefix hit to its cold run. Here qwen1.5-0.5b at full
width prefills that request's prompt (the system prompt's first 200
tokens and 40 of its own, ``chip_smoke.cow_prefill_noise``'s pair) as
one chunk (M = 240, the cold run) and as the warm run builds it: the
256-token system prompt's chunk (M = 256), then the remainder from 200
(M = 40). Each op's rows of positions 0-199 (from the system chunk) and
200-239 (from the remainder) are compared with the cold chunk's.

``--case oneshot``: ``chip_smoke.py``'s ``[oneshot]`` holds the lm
one-shot server's greedy streams to the engine's. Here qwen1.5-0.5b at
full width prefills one serve-phase prompt of more than 256 tokens
(``chip_smoke.make_requests``) through the one-shot ``api.prefill_fn``
(the whole prompt in one call, flash attention over its own K/V) and
through the engine's ``api.prefill_chunk_fn`` in chunks of 256 (flash
attention over the slot's gathered pool); each op's rows of every
position are compared.

All record the output of every call of the model's ops in call order:
``common.rms_norm``, ``common.dense`` (named by its weight's shape),
``common.swiglu``, ``common.apply_rope``, ``attention.flash_attention``,
``ops.paged_attention``,
``ssd.causal_conv1d``, ``ssd._ssd_chunk_scan`` (its output y),
``moe.moe_forward`` (an MoE layer's output; its capacity routing depends
on M too) and the serving head. For each op they print how many calls differ between the
two runs (the first 8 rows; for ssm-prefill the 256 positions, the
64-token calls concatenated) and the first such call (layer, 24 or 48
for the final norm and head, and op); the first differing call is the
op that starts the difference. Prints the card's name and power limit
first and one JSON object as the last line (also written to ``--out``);
exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class Recorder:
    """Wraps the model's ops to record every call's output, in order."""

    def __init__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import attention, common, lm, moe, ssd
        self.calls: list = []
        self.saved = []
        for owner, name, label in (
                (common, "rms_norm", "rms_norm"),
                (common, "dense", lambda x, w, *r: f"dense {tuple(w.shape)}"),
                (common, "swiglu", "swiglu"),
                (common, "apply_rope", "apply_rope"),
                (attention, "flash_attention", "flash_attention"),
                (ops, "paged_attention", "paged_attention"),
                (ssd, "causal_conv1d", "causal_conv1d"),
                (ssd, "_ssd_chunk_scan", "ssd_chunk_scan"),
                (moe, "moe_forward", "moe_forward"),
                (lm, "_serving_logits", "serving head")):
            self._wrap(owner, name, label)

    def _wrap(self, owner, name, label):
        fn = getattr(owner, name)

        def recorded(*a, **k):
            out = fn(*a, **k)
            first = out[0] if isinstance(out, tuple) else out
            self.calls.append((label(*a) if callable(label) else label,
                               first.detach().clone()))
            return out

        setattr(owner, name, recorded)
        self.saved.append((owner, name, fn))

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out

    def close(self) -> None:
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def compare(a_calls, b_calls, rows_a, rows_b, num_layers,
            norms_per_layer: int = 2) -> dict:
    """Per op: calls whose rows differ between the two runs, the first
    such (call index, layer), the largest |difference|."""
    import torch
    per_op: dict = {}
    first = None
    norms = 0        # the layers' norms in order, then the final norm
    for i, ((tag, a), (tag2, b)) in enumerate(zip(a_calls, b_calls)):
        assert tag == tag2, (i, tag, tag2)
        # a norm opens its part of a layer; other ops belong to the layer
        # of the last norm before them
        seen = norms if tag == "rms_norm" else max(norms - 1, 0)
        layer = min(seen // norms_per_layer, num_layers)
        norms += tag == "rms_norm"
        x, y = rows_a(a), rows_b(b)
        d = per_op.setdefault(tag, dict(calls=0, differ=0, first=None,
                                        max_abs=0.0))
        if x is None or y is None:      # not one row per token (an
            continue                    # MoE expert's capacity bucket)
        d["calls"] += 1
        if not torch.equal(x, y):
            diff = float((x.float() - y.float()).abs().max())
            d["differ"] += 1
            d["max_abs"] = max(d["max_abs"], diff)
            if d["first"] is None:
                d["first"] = dict(call=i, layer=layer)
            if first is None:
                first = dict(call=i, op=tag, layer=layer, max_abs=diff)
    return dict(per_op=per_op, first=first)


def report(what: str, res: dict) -> None:
    print(f"== {what}")
    for tag, d in res["per_op"].items():
        print(f"{tag}: {d['differ']} of {d['calls']} calls differ (first "
              f"at {d['first']}, max |diff| {d['max_abs']:.4g})")
    print(f"first differing call: {res['first']}")


def case_decode(dev, kv_dtype: str, arch: str) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import api, paged
    cfg = get_config(arch).with_(kv_dtype=kv_dtype)
    if cfg.mla is not None:
        cfg = cfg.with_(num_layers=3)           # chip_smoke's deepseek-v2
    params = api.init_params(cfg, device=dev, seed=cs.SEED)
    lens = [100, 37, 250, 480, 17, 300, 64, 129]
    b, m = len(lens), 40
    kv = api.KVCache.build(cfg, max_context=1024, block_size=16,
                           max_slots=b)
    base = kv.init(b, device=dev)
    table = paged.identity_table(b, kv.layout, device=dev)
    g = torch.Generator().manual_seed(cs.SEED + 2)
    for s, n in enumerate(lens):
        paged.reset_slot(base, s, table[s])
        prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=g,
                               dtype=torch.int32).to(dev)
        for p0 in range(0, n, 256):
            api.prefill_chunk_fn(cfg)(params, prompt[:, p0:p0 + 256], base,
                                      s, p0)
    first = torch.randint(0, cfg.vocab_size, (b,), generator=g,
                          dtype=torch.int32).to(dev)
    rec = Recorder()
    runs = {}
    try:
        for rows in (b, m):
            kvm = api.KVCache.build(cfg, max_context=1024, block_size=16,
                                    max_slots=rows, num_blocks=kv.num_blocks)
            c = kvm.init(rows, device=dev)
            for k, v in base.items():
                if k in ("block_table", "len"):
                    c[k][:, :b] = v
                else:
                    c[k].copy_(v)
            tok = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
            tok[:b, 0] = first
            rec.take()
            api.decode_fn(cfg)(params, tok, c)
            torch.cuda.synchronize()
            runs[rows] = rec.take()
    finally:
        rec.close()
    # MLA layers add q_norm and kv_norm to the two block norms
    res = compare(runs[b], runs[m],
                  lambda t: t.reshape(b, -1) if t.shape[0] == b else None,
                  lambda t: t.reshape(m, -1)[:b] if t.shape[0] == m
                  else None, cfg.num_layers,
                  4 if cfg.mla is not None else 2)
    report(f"{arch} {kv_dtype} decode step, M = {b} against M = {m}", res)
    return res


def case_ssm_prefill(dev) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import api
    base = get_config("mamba2-780m")
    params = api.init_params(base, device=dev, seed=cs.SEED)
    tok = torch.randint(0, base.vocab_size, (1, 256), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(cs.SEED + 3)
                        ).to(dev)
    out = {}
    for ssd_chunk in (base.ssm.chunk, 64):
        cfg = base.with_(ssm=base.ssm._replace(chunk=ssd_chunk))
        rec = Recorder()
        runs = {}
        try:
            for chunk in (256, 64):
                kv = api.KVCache.build(cfg, max_context=1024, block_size=16,
                                       max_slots=1)
                c = kv.init(1, device=dev)
                rec.take()
                calls = []
                for p0 in range(0, 256, chunk):
                    api.prefill_chunk_fn(cfg)(params, tok[:, p0:p0 + chunk],
                                              c, 0, p0)
                    calls.append(rec.take())
                torch.cuda.synchronize()
                # one record per op: the chunks' outputs along the sequence
                runs[chunk] = [
                    (tag, torch.cat([cl[i][1] for cl in calls], dim=1)
                     if tag not in ("serving head",) else calls[-1][i][1])
                    for i, (tag, _) in enumerate(calls[0])]
        finally:
            rec.close()
        res = compare(runs[256], runs[64], lambda t: t, lambda t: t,
                      cfg.num_layers)
        report(f"mamba2-780m prefill of 256 tokens, one chunk against four "
               f"of 64, SSD chunk {ssd_chunk}", res)
        out[f"ssd_chunk_{ssd_chunk}"] = res
    return out


def case_cow_prefill(dev, kv_dtype: str) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import api, paged
    cfg = get_config("qwen1.5-0.5b").with_(kv_dtype=kv_dtype)
    params = api.init_params(cfg, device=dev, seed=cs.SEED)
    g = torch.Generator().manual_seed(cs.SEED + 4)
    hit = 200
    prompt = cs.system_prompt(cfg)[:hit] + cs.random_tokens(g, cfg, 40, 40)
    chunk = api.prefill_chunk_fn(cfg)
    rec = Recorder()

    def run(chunks) -> list:
        kv = api.KVCache.build(cfg, max_context=cs.SERVE_KW["max_context"],
                               block_size=cs.SERVE_KW["block_size"],
                               max_slots=1)
        caches = kv.init(1, device=dev)
        paged.reset_slot(caches, 0, torch.arange(
            1, 1 + kv.layout.max_blocks, dtype=torch.int32, device=dev))
        calls = []
        for toks, pos0 in chunks:
            rec.take()
            chunk(params, torch.tensor([toks], dtype=torch.int32,
                                       device=dev), caches, 0, pos0)
            torch.cuda.synchronize()
            calls.append(rec.take())
        return calls

    def rows(tag, t):
        """The call's positions along dim 0 (the head: its one row)."""
        if tag == "serving head":
            return t
        return t[0].transpose(0, 1) if tag == "apply_rope" else t[0]

    try:
        (cold,) = run([(prompt, 0)])
        sys_calls, rem_calls = run([(cs.system_prompt(cfg), 0),
                                    (prompt[hit:], hit)])
    finally:
        rec.close()
    cold = [(tag, rows(tag, t)) for tag, t in cold]
    warm = [(tag, rem if tag == "serving head" else
             torch.cat([rows(tag, s_t)[:hit], rows(tag, rem)]))
            for (tag, s_t), (_, rem) in zip(sys_calls, rem_calls)]
    res = compare(cold, warm, lambda t: t, lambda t: t, cfg.num_layers)
    report(f"qwen1.5-0.5b {kv_dtype} copy-on-write prefill: {len(prompt)} "
           f"tokens at M = {len(prompt)} against the system chunk (M = "
           f"{len(cs.system_prompt(cfg))}, rows 0-{hit - 1}) + the "
           f"remainder (M = {len(prompt) - hit})", res)
    return res


def case_oneshot(dev, kv_dtype: str) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import api, paged
    cfg = get_config("qwen1.5-0.5b").with_(kv_dtype=kv_dtype)
    params = api.init_params(cfg, device=dev, seed=cs.SEED)
    chunk_len = cs.SERVE_KW["prefill_chunk"]
    req = next(r for r in cs.make_requests(cfg) if len(r.prompt) > chunk_len)
    prompt = req.prompt
    rec = Recorder()

    def rows(tag, t):
        """The call's positions along dim 0 (the head: its one row)."""
        if tag == "serving head":
            return t
        return t[0].transpose(0, 1) if tag == "apply_rope" else t[0]

    try:
        rec.take()
        api.prefill_fn(cfg, cs.SERVE_KW["max_context"])(
            params, {"tokens": torch.tensor([prompt], dtype=torch.int32,
                                            device=dev)})
        torch.cuda.synchronize()
        oneshot = rec.take()
        kv = api.KVCache.build(cfg, max_context=cs.SERVE_KW["max_context"],
                               block_size=cs.SERVE_KW["block_size"],
                               max_slots=1)
        caches = kv.init(1, device=dev)
        paged.reset_slot(caches, 0, torch.arange(
            1, 1 + kv.layout.max_blocks, dtype=torch.int32, device=dev))
        chunks = []
        for p0 in range(0, len(prompt), chunk_len):
            rec.take()
            api.prefill_chunk_fn(cfg)(params, torch.tensor(
                [prompt[p0:p0 + chunk_len]], dtype=torch.int32, device=dev),
                caches, 0, p0)
            torch.cuda.synchronize()
            chunks.append(rec.take())
    finally:
        rec.close()
    one = [(tag, rows(tag, t)) for tag, t in oneshot]
    engine = [(calls[0][0], calls[-1][1] if calls[0][0] == "serving head"
               else torch.cat([rows(tag, t) for tag, t in calls]))
              for calls in zip(*chunks)]
    res = compare(one, engine, lambda t: t, lambda t: t, cfg.num_layers)
    report(f"qwen1.5-0.5b {kv_dtype} request {req.rid}: {len(prompt)} "
           f"prompt tokens, one-shot prefill (M = {len(prompt)}) against "
           f"the engine's {len(chunks)} chunks of {chunk_len}", res)
    return dict(res, rid=req.rid, tokens=len(prompt))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="decode",
                    choices=("decode", "ssm-prefill", "cow-prefill",
                             "oneshot"))
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=("qwen1.5-0.5b", "deepseek-v2-236b"))
    ap.add_argument("--kv-dtype", default="bf16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("verify_m_ops: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from repro_torch import device as _device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    _device.set_numerics()
    dev = torch.device("cuda")
    if args.case == "decode":
        res = case_decode(dev, args.kv_dtype, args.arch)
    elif args.case == "cow-prefill":
        res = case_cow_prefill(dev, args.kv_dtype)
    elif args.case == "oneshot":
        res = case_oneshot(dev, args.kv_dtype)
    else:
        res = case_ssm_prefill(dev)
    out = dict(device=smi, case=args.case, arch=args.arch,
               kv_dtype=args.kv_dtype, result=res)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
