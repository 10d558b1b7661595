"""Port speculative serving: ``repro_torch.spec`` (window packing, the
greedy accept rule, the n-gram and draft-model proposers) and
``SpecDecodeEngine`` on the CPU (plain twins), against the reference on
the same parameters and requests, plus the contracts of
tests/test_spec.py mirrored inside the port.

Across frameworks: packing, the accept rule and n-gram drafts are equal
bit for bit (pure Python / numpy); engine streams and the ``spec_*``
counters equal the reference engine's on the prompts of
tests/test_torch_serving.py (seed 3), whose streams pass no near-tie.

Inside the port: greedy spec streams equal the port's non-spec greedy
streams. The verify window computes its projections and LM head at
M = S * C rows where decode runs M = B (tests/test_torch_verify.py), so
its logits are the decode step's to f32 rounding, not bitwise: streams
are equal on the test prompts, logprobs to 1e-5, and the entries a
rejected window leaves behind equal to a decode's within one storage
step.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import api, common  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import SpecDecodeEngine as RefSpec  # noqa: E402
from repro.spec import DraftModelProposer as RefDraft  # noqa: E402
from repro.spec import NGramProposer as RefNGram  # noqa: E402
from repro.spec import greedy_verify as ref_greedy_verify  # noqa: E402
from repro.spec import pack_windows as ref_pack_windows  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import paged as tpaged  # noqa: E402
from repro_torch.quant import core as tq  # noqa: E402
from repro_torch.serving.engine import (DecodeEngine, Request,  # noqa: E402
                                        SpecDecodeEngine)
from repro_torch.serving.faults import ProposerStallError  # noqa: E402
from repro_torch.spec import (DraftModelProposer, NGramProposer,  # noqa: E402
                              Proposer, greedy_verify, pack_windows)

MAX_CONTEXT, BLOCK, CHUNK = 64, 16, 8
# mixed workload: the long prompt spans several chunks, so its prefill
# interleaves with the others' verify steps
PROMPTS = [[5, 9, 11], list(range(20, 52)), [7, 8]]
SPEC_KEYS = ("spec_steps", "spec_slot_steps", "spec_drafted",
             "spec_accepted", "spec_emitted", "proposer_stalls",
             "paged_bytes", "paged_bytes_bf16", "contiguous_bytes",
             "decode_steps", "prefill_chunks", "prefill_tokens")


def _tcfg(**kw):
    return t_reduced(t_get_config("qwen1.5-0.5b")).with_(**kw)


@pytest.fixture(scope="module")
def port():
    cfg = _tcfg()
    return cfg, tapi.init_params(cfg, device="cpu", seed=0)


def _run(cfg, params, cls, prompts=None, max_new=10, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_context", MAX_CONTEXT)
    kw.setdefault("block_size", BLOCK)
    kw.setdefault("prefill_chunk", CHUNK)
    engine = cls(cfg, params, device="cpu", **kw)
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts or PROMPTS)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    assert all(r.done for r in reqs)
    return reqs, engine


# ------------------------------------------------- vs the reference -------

class _Req:
    def __init__(self, rid, output, slot, prefill_pos):
        self.rid, self.output, self.slot = rid, output, slot
        self.prefill_pos = prefill_pos


def test_pack_windows_and_greedy_verify_match_reference():
    rng = np.random.default_rng(0)
    for trial in range(20):
        n, k_max = int(rng.integers(1, 5)), int(rng.integers(1, 5))
        reqs = [_Req(i, rng.integers(0, 99, int(rng.integers(1, 6)))
                     .tolist(), int(s), int(rng.integers(1, 40)))
                for i, s in enumerate(rng.permutation(6)[:n])]
        ks = rng.integers(0, k_max + 1, n).tolist()
        drafts = [rng.integers(0, 99, k).tolist() for k in ks]
        got = pack_windows(reqs, ks, drafts, 6, k_max + 1)
        want = ref_pack_windows(reqs, ks, drafts, 6, k_max + 1)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        for i in range(n):
            am = rng.integers(0, 3, k_max + 1)
            d = rng.integers(0, 3, ks[i]).tolist()
            assert greedy_verify(am, d) == ref_greedy_verify(am, d)
    with pytest.raises(ValueError):
        pack_windows(reqs, [k_max + 1] * n, drafts, 6, k_max + 1)


def test_ngram_drafts_match_reference():
    rng = np.random.default_rng(1)
    for max_n, min_n in ((3, 1), (2, 2), (4, 1)):
        ours, ref = NGramProposer(max_n, min_n), RefNGram(max_n, min_n)
        for trial in range(30):
            hist = rng.integers(0, 5, int(rng.integers(1, 30))).tolist()
            r = _Req(0, hist[-3:] or [1], 0, 0)
            r.prompt = hist[:-3]
            k = int(rng.integers(0, 6))
            assert ours.propose([r], [k]) == ref.propose([r], [k])
    with pytest.raises(ValueError):
        NGramProposer(1, 2)


# (proposer, spec_k, kv pools): each case runs the reference engine and
# the port's on the reference's parameters
REF_CASES = [("ngram", 1, "bf16"), ("ngram", 4, "bf16"), ("draft", 3, "bf16"),
             ("ngram", 3, "int8"), ("ngram", 3, "fp8")]


@pytest.mark.parametrize("proposer,k,kv_dtype", REF_CASES)
def test_spec_engine_matches_reference_engine(proposer, k, kv_dtype):
    seed = 3
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(
        num_layers=2, kv_dtype=kv_dtype, num_kv_heads=2)
    tcfg = _tcfg(kv_dtype=kv_dtype, num_kv_heads=2)
    params = common.init_params(api.schema(cfg), jax.random.key(seed))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, int(rng.integers(3, 30))).tolist()
               for _ in range(3)]
    kw = dict(max_slots=2, max_context=MAX_CONTEXT, block_size=BLOCK,
              prefill_chunk=32, spec_k=k)
    ref_prop = RefNGram() if proposer == "ngram" else RefDraft(cfg, params)
    engine = RefSpec(cfg, params, proposer=ref_prop, **kw)
    ref = [RefRequest(rid=i, prompt=p, max_new_tokens=8)
           for i, p in enumerate(prompts)]
    for r in ref:
        engine.submit(r)
    engine.run_until_done()
    prop = NGramProposer() if proposer == "ngram" else \
        DraftModelProposer(tcfg, tparams)
    teng = SpecDecodeEngine(tcfg, tparams, proposer=prop, device="cpu", **kw)
    got = [Request(rid=i, prompt=p, max_new_tokens=8)
           for i, p in enumerate(prompts)]
    for r in got:
        teng.submit(r)
    teng.run_until_done()
    for r, g in zip(ref, got):
        assert g.done and g.output == r.output, (r.rid, r.output, g.output)
    for key in SPEC_KEYS:
        assert teng.kv_stats[key] == engine.kv_stats[key], key
    assert teng.acceptance_rate == engine.acceptance_rate
    assert teng.mean_accepted_length == engine.mean_accepted_length
    if proposer == "draft":
        assert teng.acceptance_rate == 1.0


# ------------------------------------------------- inside the port --------

@pytest.mark.parametrize("k", [1, 4])
def test_ngram_greedy_matches_nonspec(port, k):
    cfg, params = port
    base, _ = _run(cfg, params, DecodeEngine)
    spec, engine = _run(cfg, params, SpecDecodeEngine,
                        proposer=NGramProposer(), spec_k=k)
    for b, s in zip(base, spec):
        assert b.output == s.output
    assert engine.kv_stats["spec_steps"] > 0


def test_self_draft_matches_and_fully_accepts(port):
    """Self-drafting (draft == target) is the acceptance upper bound: any
    rejection would mean verify and decode disagree on a token."""
    cfg, params = port
    base, _ = _run(cfg, params, DecodeEngine)
    spec, engine = _run(cfg, params, SpecDecodeEngine,
                        proposer=DraftModelProposer(cfg, params), spec_k=3)
    for b, s in zip(base, spec):
        assert b.output == s.output
        np.testing.assert_allclose(s.logprobs, b.logprobs, rtol=1e-5,
                                   atol=1e-5)
    assert engine.acceptance_rate == 1.0
    assert engine.mean_accepted_length > 2.0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_kv_spec_matches_nonspec(kv_dtype):
    cfg = _tcfg(kv_dtype=kv_dtype)
    params = tapi.init_params(cfg, device="cpu", seed=0)
    base, _ = _run(cfg, params, DecodeEngine)
    spec, _ = _run(cfg, params, SpecDecodeEngine, proposer=NGramProposer(),
                   spec_k=3)
    draft, eng = _run(cfg, params, SpecDecodeEngine,
                      proposer=DraftModelProposer(cfg, params), spec_k=3)
    for b, s, d in zip(base, spec, draft):
        assert b.output == s.output == d.output
    assert eng.acceptance_rate == 1.0


def test_full_table_request_matches_nonspec(port):
    """A request sized exactly to max_context owns every table entry, so
    window positions past the table must go to the null block, not clip
    into the slot's last block and overwrite its history."""
    cfg, params = port

    def run(cls, **kw):
        eng = cls(cfg, params, max_slots=2, max_context=MAX_CONTEXT,
                  block_size=BLOCK, prefill_chunk=32, device="cpu", **kw)
        r = Request(rid=0, prompt=list(range(2, 34)), max_new_tokens=32)
        eng.submit(r)
        eng.run_until_done()
        return r

    base = run(DecodeEngine)
    spec = run(SpecDecodeEngine, proposer=NGramProposer(), spec_k=4)
    assert base.output == spec.output and len(spec.output) == 32


def test_spec_eos_truncates_like_nonspec(port):
    cfg, params = port
    base, _ = _run(cfg, params, DecodeEngine, prompts=[PROMPTS[0]])
    eos = base[0].output[3]
    assert eos not in base[0].output[:3]

    def run(cls, **kw):
        eng = cls(cfg, params, max_slots=2, max_context=MAX_CONTEXT,
                  block_size=BLOCK, prefill_chunk=CHUNK, device="cpu", **kw)
        r = Request(rid=0, prompt=PROMPTS[0], max_new_tokens=10, eos_id=eos)
        eng.submit(r)
        eng.run_until_done()
        return r

    b = run(DecodeEngine)
    s = run(SpecDecodeEngine, proposer=DraftModelProposer(cfg, params),
            spec_k=4)
    assert s.output == b.output and s.output[-1] == eos and len(s.output) == 4


def test_per_request_spec_k_cap(port):
    cfg, params = port
    base, _ = _run(cfg, params, DecodeEngine, prompts=[PROMPTS[0]],
                   max_new=4)
    engine = SpecDecodeEngine(cfg, params, max_slots=2,
                              max_context=MAX_CONTEXT, block_size=BLOCK,
                              prefill_chunk=CHUNK, proposer=NGramProposer(),
                              spec_k=4, device="cpu")
    req = Request(rid=0, prompt=PROMPTS[0], max_new_tokens=4, spec_k=1)
    engine.submit(req)
    engine.run_until_done()
    assert req.output == base[0].output and len(req.output) == 4
    # never more than 1 draft per walk, never past the 4-token budget
    assert engine.kv_stats["spec_drafted"] <= engine.kv_stats["spec_steps"]


class _SpyProposer(NGramProposer):
    """Records who is drafted for: a slot mid-chunked-prefill never is."""

    def __init__(self):
        super().__init__()
        self.seen: list[list[int]] = []

    def propose(self, reqs, ks):
        for r in reqs:
            assert r.prefill_pos == len(r.prompt), \
                f"request {r.rid} drafted mid-prefill"
        self.seen.append([r.rid for r in reqs])
        return super().propose(reqs, ks)


def test_mid_prefill_slot_never_drafted(port):
    cfg, params = port
    outs = {}
    for name, kw in (("spec", dict(proposer=_SpyProposer(), spec_k=3)),
                     ("base", {})):
        cls = SpecDecodeEngine if kw else DecodeEngine
        engine = cls(cfg, params, max_slots=2, max_context=MAX_CONTEXT,
                     block_size=BLOCK, prefill_chunk=4, device="cpu", **kw)
        r1 = Request(rid=1, prompt=[1, 2, 3], max_new_tokens=12)
        engine.submit(r1)
        engine.step()                         # r1 resident and decoding
        r2 = Request(rid=2, prompt=list(range(5, 25)), max_new_tokens=4)
        engine.submit(r2)                     # 5 chunks of 4
        engine.run_until_done()
        outs[name] = (r1.output, r2.output)
        if kw:
            seen = kw["proposer"].seen
            assert any(calls == [1] for calls in seen)    # r1 drafted solo
            assert any(2 in calls for calls in seen)      # r2 drafted later
    assert outs["spec"] == outs["base"]


class _AlwaysWrongProposer(Proposer):
    """Cold low tokens: every draft is rejected, so each spec step emits
    one token with a maximal rollback."""

    name = "wrong"

    def propose(self, reqs, ks):
        return [[1 + (j % 3) for j in range(k)] for k in ks], \
            [None] * len(reqs)


def _deq(caches, name):
    a = caches[name]
    if a.dtype in (torch.bfloat16, torch.float32):
        return a.to(torch.float32)
    return tq.cast_f32(a) * caches[name.replace("pool", "scale")][..., None]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_rollback_leaves_state_as_nonspec(kv_dtype):
    """After every step the spec engine's tables and lengths equal a
    non-spec engine's exactly, and the live region of the pools (and
    scales) within one storage step: rejected drafts leave no trace in
    the live state."""
    cfg = _tcfg(kv_dtype=kv_dtype)
    params = tapi.init_params(cfg, device="cpu", seed=0)
    step = {"bf16": 2.0 ** -7, "int8": 1 / 127}[kv_dtype]

    def fresh(cls, **kw):
        eng = cls(cfg, params, max_slots=1, max_context=MAX_CONTEXT,
                  block_size=BLOCK, prefill_chunk=CHUNK, device="cpu", **kw)
        eng.submit(Request(rid=0, prompt=[5, 9, 11], max_new_tokens=9))
        return eng

    eng_b = fresh(DecodeEngine)
    eng_s = fresh(SpecDecodeEngine, proposer=_AlwaysWrongProposer(),
                  spec_k=3)
    for i in range(10):
        eng_b.step()
        eng_s.step()
        cb, cs = eng_b.caches, eng_s.caches
        assert torch.equal(cb["len"], cs["len"]), i
        assert torch.equal(cb["block_table"], cs["block_table"]), i
        valid = int(cb["len"][0, 0])
        if not valid:
            continue
        row = cb["block_table"][0, 0, :tpaged.cdiv(valid, BLOCK)].long()
        for name in ("kpool", "vpool"):
            vb = _deq(cb, name)[:, row].flatten(1, 2)[:, :valid]
            vs = _deq(cs, name)[:, row].flatten(1, 2)[:, :valid]
            amax = vb.abs().amax(dim=-1, keepdim=True)
            assert bool(((vb - vs).abs() <= step * amax + 1e-6).all()), \
                (name, i)
    assert not eng_b.num_unfinished and not eng_s.num_unfinished
    assert eng_s.acceptance_rate == 0.0


class _StallingProposer(NGramProposer):
    def __init__(self, stall_calls):
        super().__init__()
        self.calls, self.stall_calls = 0, stall_calls

    def propose(self, reqs, ks):
        self.calls += 1
        if self.calls in self.stall_calls:
            raise ProposerStallError("no drafts this step")
        return super().propose(reqs, ks)


def test_proposer_stall_degrades_to_one_token_per_slot(port):
    cfg, params = port
    base, _ = _run(cfg, params, DecodeEngine)
    prop = _StallingProposer(stall_calls={2, 3, 5})
    spec, engine = _run(cfg, params, SpecDecodeEngine, proposer=prop,
                        spec_k=4)
    for b, s in zip(base, spec):
        assert b.output == s.output
    st = engine.kv_stats
    assert st["proposer_stalls"] == 3
    assert st["spec_steps"] == prop.calls


def test_refusals(port):
    cfg, params = port
    engine = SpecDecodeEngine(cfg, params, proposer=NGramProposer(),
                              device="cpu")
    # sampled requests are served (exact rejection sampling)
    engine.submit(Request(rid=0, prompt=[1], max_new_tokens=2,
                          temperature=1.0))
    engine.run_until_done()
    with pytest.raises(ValueError, match="recurrent"):
        SpecDecodeEngine(cfg.with_(family="ssm"), params,
                         proposer=NGramProposer(), device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        SpecDecodeEngine(cfg, params, proposer=NGramProposer(), spec_k=0,
                         device="cpu")
    draft = DraftModelProposer(cfg, params)
    SpecDecodeEngine(cfg, params, proposer=draft, device="cpu")
    sampled = Request(rid=1, prompt=[1], max_new_tokens=2, temperature=0.7)
    sampled.slot, sampled.output = 0, [3]
    drafts, qdists = draft.propose([sampled], [2])
    assert len(drafts[0]) == 2 and qdists[0].shape == (2, cfg.vocab_size)
    with pytest.raises(ValueError, match="vocab"):
        SpecDecodeEngine(cfg, params, device="cpu", proposer=DraftModelProposer(
            cfg.with_(vocab_size=cfg.vocab_size + 1), params))


def test_spec_engine_on_card_matches_cpu(port):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cfg, params = port
    base, _ = _run(cfg, params, DecodeEngine)
    for prop in (NGramProposer(), DraftModelProposer(cfg, params)):
        engine = SpecDecodeEngine(cfg, params, max_slots=2,
                                  max_context=MAX_CONTEXT, block_size=BLOCK,
                                  prefill_chunk=CHUNK, proposer=prop,
                                  spec_k=3, device="cuda")
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=10)
                for i, p in enumerate(PROMPTS)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_done()
        for b, r in zip(base, reqs):
            assert r.output == b.output
            np.testing.assert_allclose(r.logprobs, b.logprobs, atol=0.05)
