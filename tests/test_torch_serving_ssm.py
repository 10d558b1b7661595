"""The ssm family behind the port's ``DecodeEngine`` (reduced
mamba2-780m: 2 Mamba2 layers, d_model 64, d_inner 128, 16 states) on the
CPU, against the reference engine and the reference's solo generation
on the reference's own parameters.

Mirrors tests/test_serving.py's ssm cases: a solo request, and the
regression the reference pins in ``test_ssm_interleaved_prefill_parity``
(a batched decode step must not touch the recurrent state of a slot that
is mid-prefill: the resident request and the late joiner both equal
their solo generations). Greedy tokens must be equal; logprobs agree to
the stacks' logit deviation (the mixer's bf16 products sum in another
order: within 0.05, tests/test_torch_ssd.py's mixer bound). Six mixed
requests on both engines: the streams are equal up to the first token
where they part, and they may part only at a near-tie, a reference
top-2 gap within twice ``DECODE_DEV`` (tests/test_torch_model.py's
rollout bound; on this seed request 2 parts at its second token, gap
0.0073 against a logit deviation of 0.029). Then the ssm refusals of
the engine, the speculative engine and ``verify_fn``, and the
constant-state accounting (no paged bytes).
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import api, common, paged  # noqa: E402
from repro.serving.engine import DecodeEngine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import paged as tpaged  # noqa: E402
from repro_torch.serving.engine import (DecodeEngine, Request,  # noqa: E402
                                        SpecDecodeEngine)
from repro_torch.spec import NGramProposer  # noqa: E402

MAX_CONTEXT, BLOCK, CHUNK = 64, 16, 32
LOGPROB_ATOL = 0.05
DECODE_DEV = 0.1


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("mamba2-780m"))
    params = common.init_params(api.schema(cfg), jax.random.key(1))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    return cfg, params, t_reduced(t_get_config("mamba2-780m")), tparams


def _reference_generate(cfg, params, prompt, n_new, chunk_size=CHUNK,
                        forced=None):
    """Solo greedy generation through the reference's chunked prefill and
    decode (tests/test_serving.py's oracle). With ``forced`` it feeds
    those tokens instead of its own choices and returns the logit rows."""
    layout = paged.PagedLayout(BLOCK, MAX_CONTEXT // BLOCK)
    kv = api.KVCache.build(cfg, max_context=layout.max_context,
                           block_size=layout.block_size, max_slots=1)
    caches = paged.reset_slot(kv.init(1), jnp.int32(0),
                              jnp.arange(1, 1 + layout.max_blocks,
                                         dtype=jnp.int32))
    chunk_fn = jax.jit(api.prefill_chunk_fn(cfg))
    decode = jax.jit(api.decode_fn(cfg))
    pos = 0
    while pos < len(prompt):
        chunk = prompt[pos:pos + chunk_size]
        logits, caches = chunk_fn(params, jnp.asarray([chunk], jnp.int32),
                                  caches, jnp.int32(0), jnp.int32(pos))
        pos += len(chunk)
    rows = [np.asarray(logits[0])]
    out = [int(jnp.argmax(logits[0]))]
    while len(out) < n_new:
        tok = out[-1] if forced is None else forced[len(out) - 1]
        logits, caches = decode(params, jnp.asarray([[tok]], jnp.int32),
                                caches)
        rows.append(np.asarray(logits[0]))
        out.append(int(jnp.argmax(logits[0])))
    return out if forced is None else rows


def _engine(tcfg, tparams, **kw):
    kw.setdefault("max_context", MAX_CONTEXT)
    kw.setdefault("block_size", BLOCK)
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("max_slots", 2)
    return DecodeEngine(tcfg, tparams, device="cpu", **kw)


def test_cache_is_constant_state(setup):
    cfg, _, tcfg, _ = setup
    kv = api.KVCache.build(cfg, max_context=MAX_CONTEXT, max_slots=3)
    tkv = tapi.KVCache.build(tcfg, max_context=MAX_CONTEXT, max_slots=3)
    (ref,) = kv.specs(3)
    spec = tkv.specs(3)
    assert set(spec) == set(ref) == {"ssm", "conv"}
    for k, s in ref.items():
        assert spec[k][0] == tuple(s.shape), k
    assert tkv.token_bytes(3) == kv.token_bytes(3) == 0


def test_solo_request_matches_reference(setup):
    """tests/test_serving.py's ``test_ssm_family_engine``: chunks of 2
    tokens continue the conv window and the SSD state exactly."""
    cfg, params, tcfg, tparams = setup
    engine = _engine(tcfg, tparams, prefill_chunk=2)
    req = Request(rid=0, prompt=[4, 8, 15], max_new_tokens=5)
    engine.submit(req)
    engine.run_until_done()
    assert req.done and len(req.output) == 5
    assert req.output == _reference_generate(cfg, params, [4, 8, 15], 5,
                                             chunk_size=2)
    assert engine.kv_stats["paged_bytes"] == 0
    assert engine.kv_stats["contiguous_bytes"] == 0


def test_interleaved_prefill_parity(setup):
    """The regression of ``test_ssm_interleaved_prefill_parity``: r2's
    five prompt chunks interleave with r1's decode steps, and both equal
    their solo generations."""
    cfg, params, tcfg, tparams = setup
    engine = _engine(tcfg, tparams, prefill_chunk=4)
    r1 = Request(rid=1, prompt=[4, 8, 15], max_new_tokens=10)
    engine.submit(r1)
    engine.step()                      # r1 resident and decoding
    long_prompt = list(range(3, 23))   # 5 chunks, interleaved with decode
    r2 = Request(rid=2, prompt=long_prompt, max_new_tokens=4)
    engine.submit(r2)
    engine.run_until_done()
    assert r1.done and r2.done
    assert r1.output == _reference_generate(cfg, params, [4, 8, 15], 10,
                                            chunk_size=4)
    assert r2.output == _reference_generate(cfg, params, long_prompt, 4,
                                            chunk_size=4)


def test_decode_leaves_prefilling_slot_alone(setup):
    """Inside the port: the state of a slot that is mid-prefill is the
    same bits before and after a batched decode step."""
    _, _, tcfg, tparams = setup
    engine = _engine(tcfg, tparams, prefill_chunk=4)
    r1 = Request(rid=1, prompt=[4, 8, 15], max_new_tokens=8)
    engine.submit(r1)
    engine.step()
    engine.submit(Request(rid=2, prompt=list(range(3, 23)),
                          max_new_tokens=2))
    engine.step()                      # r2 admitted, first chunk in
    (r2,) = engine.scheduler.prefilling
    before = {k: v.clone() for k, v in engine.caches.items()}
    engine._decode_step()
    for k, v in engine.caches.items():
        assert torch.equal(v[:, r2.slot], before[k][:, r2.slot]), k
        # the decoding slot's state and window did move
        assert not torch.equal(v[:, r1.slot], before[k][:, r1.slot]), k


def test_engine_matches_reference_engine(setup):
    """Six requests on 2 slots, both engines: streams equal up to a
    near-tie (see the module docstring), logprobs within
    ``LOGPROB_ATOL`` up to there, the same step counts."""
    cfg, params, tcfg, tparams = setup
    prompts = [[int(t) for t in np.random.default_rng(i).integers(
        0, 256, 5 + 7 * i)] for i in range(6)]
    ref = RefEngine(cfg, params, max_slots=2, max_context=MAX_CONTEXT,
                    block_size=BLOCK, prefill_chunk=8)
    eng = _engine(tcfg, tparams, prefill_chunk=8)
    rr = [RefRequest(rid=i, prompt=p, max_new_tokens=6)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p, max_new_tokens=6)
          for i, p in enumerate(prompts)]
    for a, b in zip(rr, tr):
        ref.submit(a)
        eng.submit(b)
    ref.run_until_done()
    eng.run_until_done()
    parted = 0
    for a, b in zip(rr, tr):
        n = next((i for i, (x, y) in enumerate(zip(a.output, b.output))
                  if x != y), len(a.output))
        np.testing.assert_allclose(b.logprobs[:n], a.logprobs[:n],
                                   atol=LOGPROB_ATOL, rtol=0)
        if n < len(a.output):
            parted += 1
            row = _reference_generate(cfg, params, a.prompt, n + 1,
                                      chunk_size=8, forced=a.output)[n]
            top2 = np.sort(row)[-2:]
            assert top2[1] - top2[0] <= 2 * DECODE_DEV, (b.rid, n)
    assert parted <= 1
    assert eng.kv_stats["paged_bytes"] == ref.kv_stats["paged_bytes"] == 0
    assert eng.kv_stats["decode_steps"] == ref.kv_stats["decode_steps"]
    assert eng.kv_stats["prefill_chunks"] == ref.kv_stats["prefill_chunks"]


def test_reset_slot_zeroes_recurrent_state(setup):
    """``paged.reset_slot`` zeroes the slot's ``ssm`` / ``conv`` slices,
    as the reference's does, and leaves the other slots alone."""
    _, _, tcfg, _ = setup
    kv = tapi.KVCache.build(tcfg, max_context=MAX_CONTEXT, max_slots=3)
    c = {k: torch.randn(v.shape).to(v.dtype)
         for k, v in kv.init(3, device="cpu").items()}
    keep = {k: v.clone() for k, v in c.items()}
    tpaged.reset_slot(c, 1, torch.zeros(kv.layout.max_blocks,
                                        dtype=torch.int32))
    for k, v in c.items():
        assert not bool(v[:, 1].any()), k
        assert torch.equal(v[:, 0], keep[k][:, 0])
        assert torch.equal(v[:, 2], keep[k][:, 2])


def test_ssm_refusals(setup):
    _, _, tcfg, tparams = setup
    with pytest.raises(ValueError, match="prefix caching shares paged KV"):
        _engine(tcfg, tparams, prefix_cache=True)
    with pytest.raises(ValueError, match="preemption snapshots paged KV"):
        _engine(tcfg, tparams, preempt="lru")
    with pytest.raises(ValueError, match="carries recurrent state"):
        SpecDecodeEngine(tcfg, tparams, proposer=NGramProposer(),
                         max_slots=2, max_context=MAX_CONTEXT,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="paged-KV"):
        tapi.verify_fn(tcfg)
