"""Sampled speculative decoding in the port: ``repro_torch.spec.sampler``
(``emit_key``, ``target_dist``, ``rejection_sample``) bitwise against
``repro.spec.sampler`` on identical rows, drafts and proposals; sampled
drafting of ``DraftModelProposer`` and the sampled ``SpecDecodeEngine``
against the reference's on bridged weights; and tests/test_spec.py's
sampled contracts inside the port.

The sampler is a host rule over numpy float64 and keyed scalar uniforms,
so it is held bit for bit. Across the two stacks the logits differ by up
to ``ROW_ATOL`` on these tiny random weights, which is enough to move an
inverse-CDF draw across a boundary now and then; the engine tests hold
what the sampler is given and what it returns, draw by draw, up to the
first such flip.
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
from repro.spec import sampler as ref_sampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serving.engine import (Request,  # noqa: E402
                                        SpecDecodeEngine)
from repro_torch.spec import (DraftModelProposer, NGramProposer,  # noqa: E402
                              rejection_sample, sampler)

MAX_CONTEXT, BLOCK, CHUNK = 64, 16, 32
# the stacks' decode logits differ by up to 0.066 over bf16 pools on
# these weights (tests/test_torch_model.py); measured here 0.06 on verify
# rows and 0.117 on a proposal probability at temperature 0.9
ROW_ATOL = 0.1
Q_ATOL = 0.2


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _tcfg(**kw):
    return t_reduced(t_get_config("qwen1.5-0.5b")).with_(**kw)


@pytest.fixture(scope="module")
def port():
    cfg = _tcfg()
    return cfg, tapi.init_params(cfg, device="cpu", seed=0)


# ------------------------------------------------- vs the reference -------

def test_emit_key_and_salts_match_reference():
    assert (sampler.ACCEPT_SALT, sampler.RESIDUAL_SALT, sampler.BONUS_SALT,
            sampler.DRAFT_SALT) == (ref_sampler.ACCEPT_SALT,
                                    ref_sampler.RESIDUAL_SALT,
                                    ref_sampler.BONUS_SALT,
                                    ref_sampler.DRAFT_SALT)
    for seed, idx in ((0, 0), (7, 3), (2 ** 31 + 1, 40), (123, 999)):
        want = np.asarray(jax.random.key_data(ref_sampler.emit_key(seed,
                                                                   idx)))
        np.testing.assert_array_equal(sampler.emit_key(seed, idx).numpy(),
                                      want.astype(np.int64))


@pytest.mark.parametrize("top_k", [0, 1, 5, 64, 500])
def test_target_dist_matches_reference_bitwise(top_k):
    rng = np.random.default_rng(top_k)
    for trial in range(6):
        row = (rng.normal(size=300) * 3).astype(np.float32)
        if trial == 1:
            row[::4] = np.sort(row)[-5]          # ties at the k-th value
        if trial == 2:
            row[:] = 0.5                         # all tied
        temp = (0.3, 1.0, 1.7, 0.0, 1e-8, 2.0)[trial]
        got = sampler.target_dist(row, temp, top_k)
        want = ref_sampler.target_dist(row, temp, top_k)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("proposal", ["point", "full"])
def test_rejection_sample_matches_reference_bitwise(proposal):
    rng = np.random.default_rng(1 if proposal == "point" else 2)
    v = 40
    for trial in range(60):
        k = int(rng.integers(0, 5))
        rows = (rng.normal(size=(k + 1, v)) * 2).astype(np.float32)
        temp = float(rng.choice([0.5, 1.0, 1.6]))
        top_k = int(rng.choice([0, 3, 10]))
        seed, base = int(rng.integers(0, 2 ** 31)), int(rng.integers(0, 50))
        if proposal == "point":
            q = None
            # drafts near the target's mode get accepted now and then
            drafts = [int(np.argsort(r)[-1 - int(rng.integers(0, 3))])
                      for r in rows[:k]]
        else:
            q = np.stack([ref_sampler.target_dist(
                rows[j] + rng.normal(size=v).astype(np.float32), temp, 0)
                for j in range(k)]) if k else np.zeros((0, v))
            drafts = [int(rng.choice(v, p=q[j])) for j in range(k)]
            if trial % 7 == 0 and k:
                q[0, drafts[0]] = 0.0            # a proposer that "could
                # not" have drawn its draft: a certain rejection
        got = rejection_sample(rows, drafts, q, temp, top_k, seed, base)
        want = ref_sampler.rejection_sample(rows, drafts, q, temp, top_k,
                                            seed, base)
        assert got == want, (trial, got, want)


def _bridged(seed=3):
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(num_layers=2,
                                                     num_kv_heads=2)
    params = common.init_params(api.schema(cfg), jax.random.key(seed))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    return cfg, params, _tcfg(num_kv_heads=2), tparams


def _recorder(calls, fn):
    def recorded(rows, drafts, qdists, temperature, top_k, seed, base):
        out = fn(rows, drafts, qdists, temperature, top_k, seed, base)
        calls.append(dict(rows=np.array(rows, np.float64),
                          drafts=[int(d) for d in drafts], seed=seed,
                          base=base, temperature=temperature, top_k=top_k,
                          qdists=qdists, out=out))
        return out
    return recorded


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
def test_sampled_spec_engine_follows_reference(proposer, monkeypatch):
    """Sampled requests (and one greedy) under speculation on the
    reference's weights. The greedy stream is equal. Each sampled verify
    step calls the accept rule with the reference's seed, emit index,
    temperature, top_k and drafts, on rows within ``ROW_ATOL`` of the
    reference's, and gives the reference rule's tokens on its own rows;
    across the stacks this holds per request up to the first draw
    (drafted or verified) that the logit deviation of the stacks flips:
    the histories differ from there on, as expected of a sampler fed
    other logits. Within the port it holds for every call of the stream:
    the emit index follows the request's output, n-gram drafts are the
    reference proposer's on the port's history, and the output is the
    concatenation of what the rule returned."""
    cfg, params, tcfg, tparams = _bridged()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, int(rng.integers(3, 30))).tolist()
               for _ in range(3)]
    knobs = [dict(temperature=0.8, top_k=20, seed=5),
             dict(temperature=1.2, seed=6), dict()]
    kw = dict(max_slots=3, max_context=MAX_CONTEXT, block_size=BLOCK,
              prefill_chunk=CHUNK, spec_k=3)
    calls = {"ref": [], "port": []}
    monkeypatch.setattr(ref_sampler, "rejection_sample",
                        _recorder(calls["ref"], ref_sampler.rejection_sample))
    monkeypatch.setattr(sampler, "rejection_sample",
                        _recorder(calls["port"], sampler.rejection_sample))

    def run(engine, cls):
        reqs = [cls(rid=i, prompt=p, max_new_tokens=12, **kn)
                for i, (p, kn) in enumerate(zip(prompts, knobs))]
        for r in reqs:
            engine.submit(r)
        engine.run_until_done()
        return reqs

    ref_prop = RefNGram() if proposer == "ngram" else RefDraft(cfg, params)
    ref = run(RefSpec(cfg, params, proposer=ref_prop, **kw), RefRequest)
    prop = NGramProposer() if proposer == "ngram" else \
        DraftModelProposer(tcfg, tparams)
    got = run(SpecDecodeEngine(tcfg, tparams, proposer=prop, device="cpu",
                               **kw), Request)
    assert all(g.done for g in got)
    assert got[2].output == ref[2].output                 # greedy
    for req, kn in zip(got[:2], knobs):
        seed = kn["seed"]
        mine = [c for c in calls["port"] if c["seed"] == seed]
        theirs = [c for c in calls["ref"] if c["seed"] == seed]
        # every port call, past any flip too: the engine gives the rule
        # the request's emit index, knobs and (n-gram) the reference
        # proposer's drafts on the port's own history, the port's rule
        # answers as the reference's on those inputs, and the stream is
        # exactly what the rule returned
        emitted = req.output[:1]
        for c in mine:
            assert (c["base"], c["temperature"], c["top_k"]) == (
                len(emitted), kn["temperature"], kn.get("top_k", 0))
            if proposer == "ngram":
                assert c["drafts"] == RefNGram()._lookup(
                    list(req.prompt) + emitted, len(c["drafts"]))
            assert c["out"] == ref_sampler.rejection_sample(
                c["rows"].astype(np.float32), c["drafts"], c["qdists"],
                c["temperature"], c["top_k"], seed, c["base"])
            emitted = emitted + list(c["out"][1])
        assert req.output == emitted[:len(req.output)]
        # across the stacks, call by call up to the first flip
        aligned = 0
        for a, b in zip(mine, theirs):
            for key in ("base", "temperature", "top_k"):
                assert a[key] == b[key], key
            if a["drafts"] != b["drafts"]:
                break                        # a sampled draft flipped
            assert np.abs(a["rows"] - b["rows"]).max() <= ROW_ATOL
            aligned += 1
            if a["out"] != b["out"]:
                break                        # the histories part here
        assert aligned >= 1, seed     # n-gram 1 and 4, self-draft 1 and 2


def test_sampled_drafts_match_reference():
    """The draft proposer alone, its mirror prefilled with the same
    prompts and pending tokens on bridged weights: the greedy request's
    drafts equal the reference's; each of the sampled request's drafts is
    the reference's keyed inverse-CDF draw (the jax key at emit index
    len(output) + j, salted by DRAFT_SALT) from the port's own proposal
    row, and those rows equal the reference's within ``Q_ATOL`` up to the
    first draft that the logit deviation flips (the next row conditions
    on another token)."""
    cfg, params, tcfg, tparams = _bridged()
    kw = dict(max_slots=2, max_context=MAX_CONTEXT, block_size=BLOCK,
              prefill_chunk=CHUNK, spec_k=3)
    prompts = [[5, 9, 11, 40, 2], [7, 8, 1]]
    knobs = [dict(temperature=0.9, top_k=30, seed=21), dict()]
    results = []
    for eng, cls in ((RefSpec(cfg, params, proposer=RefDraft(cfg, params),
                              **kw), RefRequest),
                     (SpecDecodeEngine(tcfg, tparams, device="cpu",
                                       proposer=DraftModelProposer(
                                           tcfg, tparams), **kw), Request)):
        reqs = []
        for i, (p, kn) in enumerate(zip(prompts, knobs)):
            r = cls(rid=i, prompt=p, max_new_tokens=8, **kn)
            r.slot, r.output = i, [17 + i]
            eng.proposer.on_admit(r)
            eng.proposer.on_prefill_chunk(r, p, 0)
            reqs.append(r)
        results.append(eng.proposer.propose(reqs, [3, 2]))
    (ref_d, ref_q), (got_d, got_q) = results
    assert got_d[1] == ref_d[1] and ref_q[1] is None and got_q[1] is None
    assert got_q[0].shape == ref_q[0].shape == (3, cfg.vocab_size)
    for j, d in enumerate(got_d[0]):
        key = jax.random.fold_in(ref_sampler.emit_key(21, 1 + j),
                                 ref_sampler.DRAFT_SALT)
        assert d == ref_sampler._inverse_cdf(
            got_q[0][j], float(jax.random.uniform(key)))
        np.testing.assert_allclose(got_q[0][j], ref_q[0][j], atol=Q_ATOL,
                                   rtol=0)
        if d != ref_d[0][j]:
            break


# ------------------------------------------------- inside the port --------

def test_rejection_sampler_preserves_target_distribution():
    """Monte Carlo over seeds (tests/test_spec.py's contract): a point
    mass or a full proposal, the emitted marginal is the target's."""
    rng = np.random.default_rng(0)
    v = 16
    rows = (rng.normal(size=(2, v)) * 2).astype(np.float32)
    temp, top_k = 1.3, 6
    p = sampler.target_dist(rows[0], temp, top_k)
    n = 4000
    counts = np.zeros(v)
    for s in range(n):
        _, em = rejection_sample(rows, [3], None, temp, top_k, seed=s,
                                 emit_base=0)
        counts[em[0]] += 1
    assert 0.5 * np.abs(counts / n - p).sum() < 0.05
    q = sampler.target_dist((rng.normal(size=v) * 2).astype(np.float32),
                            temp, 0)
    counts = np.zeros(v)
    for s in range(n):
        d = int(np.searchsorted(np.cumsum(q), rng.random()))
        _, em = rejection_sample(rows, [d], q[None], temp, top_k, seed=s,
                                 emit_base=0)
        counts[em[0]] += 1
    assert 0.5 * np.abs(counts / n - p).sum() < 0.05


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
def test_sampled_spec_reproducible_and_batch_invariant(port, proposer):
    """Keyed on (seed, emit index): the same seed reproduces the stream
    across engines and batch compositions; seeds matter."""
    cfg, params = port

    def gen(seed, companion=False):
        prop = NGramProposer() if proposer == "ngram" else \
            DraftModelProposer(cfg, params)
        engine = SpecDecodeEngine(cfg, params, max_slots=2,
                                  max_context=MAX_CONTEXT, block_size=BLOCK,
                                  prefill_chunk=CHUNK, proposer=prop,
                                  spec_k=3, device="cpu")
        req = Request(rid=0, prompt=[5, 9, 11], max_new_tokens=8,
                      temperature=1.5, top_k=20, seed=seed)
        engine.submit(req)
        if companion:
            engine.submit(Request(rid=1, prompt=[1, 2], max_new_tokens=8))
        engine.run_until_done()
        return req.output

    solo = gen(7)
    assert gen(7) == solo
    assert gen(7, companion=True) == solo
    assert len({tuple(gen(s)) for s in (7, 8, 9)}) > 1


def test_sampled_spec_on_card_matches_cpu(port):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cfg, params = port

    def run(device):
        engine = SpecDecodeEngine(cfg, params, max_slots=2,
                                  max_context=MAX_CONTEXT, block_size=BLOCK,
                                  prefill_chunk=CHUNK, spec_k=3,
                                  proposer=NGramProposer(), device=device)
        reqs = [Request(rid=i, prompt=[3 + i, 1, 4, 1, 5], max_new_tokens=6,
                        temperature=0.9, top_k=10, seed=i)
                for i in range(3)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_done()
        return [r.output for r in reqs]

    assert run("cuda") == run("cpu")
