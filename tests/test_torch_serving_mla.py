"""Port serving engine on the MLA + MoE family: ``DecodeEngine`` serving
reduced deepseek-v2 (1 dense + 1 MoE layer, latent pools) on the CPU
(plain twins) against the reference ``DecodeEngine`` on the same
parameters and requests, plus the engine contracts inside the port.

Cross-framework: greedy token streams are equal and logprobs agree to
the logit deviation of the two stacks (tests/test_torch_mla.py states
its size and the router near-tie that can flip a stream, ROADMAP C; the
request seed here is one whose streams pass no such tie). Inside the
port: batched serving emits solo serving's tokens, and a request that
joins mid-stream (its chunks interleaved with the others' decode steps,
so ``keep_slots`` restores its length over the latent pools every step)
emits its solo tokens too.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import api, common  # noqa: E402
from repro.serving.engine import DecodeEngine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402

ARCH = "deepseek-v2-236b"
MAX_CONTEXT, BLOCK, CHUNK = 64, 16, 32


@pytest.fixture(scope="module")
def port():
    cfg = t_reduced(t_get_config(ARCH))
    return cfg, tapi.init_params(cfg, device="cpu", seed=0)


def _serve(cfg, params, reqs, **kw):
    kw.setdefault("max_slots", 2)
    engine = DecodeEngine(cfg, params, max_context=MAX_CONTEXT,
                          block_size=BLOCK, device="cpu",
                          prefill_chunk=kw.pop("prefill_chunk", CHUNK), **kw)
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    return engine


def _solo(cfg, params, prompt, n, chunk=CHUNK):
    r = Request(rid=0, prompt=list(prompt), max_new_tokens=n)
    _serve(cfg, params, [r], max_slots=1, prefill_chunk=chunk)
    return r.output, r.logprobs


# max |port - reference| logprob over the three streams, measured on
# seed 3: bf16 0.018, int8 0.040 — held at about 2x
LOGPROB_ATOL = {"bf16": 0.04, "int8": 0.08}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_matches_reference_engine(kv_dtype):
    seed = 3
    cfg = reduced(get_config(ARCH)).with_(kv_dtype=kv_dtype)
    tcfg = t_reduced(t_get_config(ARCH)).with_(kv_dtype=kv_dtype)
    params = common.init_params(api.schema(cfg), jax.random.key(seed))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, int(rng.integers(3, 30))).tolist()
               for _ in range(3)]
    ref = [RefRequest(rid=i, prompt=p, max_new_tokens=8)
           for i, p in enumerate(prompts)]
    engine = RefEngine(cfg, params, max_slots=2, max_context=MAX_CONTEXT,
                       block_size=BLOCK, prefill_chunk=CHUNK)
    for r in ref:
        engine.submit(r)
    engine.run_until_done()
    got = [Request(rid=i, prompt=p, max_new_tokens=8)
           for i, p in enumerate(prompts)]
    teng = _serve(tcfg, tparams, got)
    for r, g in zip(ref, got):
        assert g.done and g.output == r.output, (r.rid, r.output, g.output)
        np.testing.assert_allclose(g.logprobs, r.logprobs,
                                   atol=LOGPROB_ATOL[kv_dtype], rtol=0)
    for k in ("paged_bytes", "paged_bytes_bf16", "contiguous_bytes",
              "decode_steps", "prefill_chunks", "prefill_tokens"):
        assert teng.kv_stats[k] == engine.kv_stats[k], k


def test_batched_equals_solo(port):
    cfg, params = port
    specs = [([5, 9, 11], 8), ([1, 2, 3, 4], 8), (list(range(5, 25)), 6)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(specs)]
    _serve(cfg, params, reqs, max_slots=3)
    for r, (p, n) in zip(reqs, specs):
        out, lps = _solo(cfg, params, p, n)
        assert r.output == out
        np.testing.assert_allclose(r.logprobs, lps, rtol=1e-5, atol=1e-5)


def test_mid_stream_join_over_latent_pools(port):
    """r2 prefills in 5 chunks while r1 decodes: every batched decode step
    also writes r2's slot, and ``keep_slots`` must put its length back;
    a retired slot's ``reset_slot`` must leave the shared latent pools
    alone. Both streams equal their solo runs at the same chunk size: MoE
    capacity depends on the chunk's token count (a 20-token chunk can
    drop assignments that 4-token chunks keep), so unlike the dense
    family, MoE prefill is not chunk-size invariant, here or in the
    reference."""
    cfg, params = port
    engine = DecodeEngine(cfg, params, max_slots=2, max_context=MAX_CONTEXT,
                          block_size=BLOCK, prefill_chunk=4, device="cpu")
    r1 = Request(rid=1, prompt=[1, 2, 3], max_new_tokens=12)
    engine.submit(r1)
    engine.step()
    r2 = Request(rid=2, prompt=list(range(5, 25)), max_new_tokens=4)
    engine.submit(r2)
    lens = []
    for _ in range(5):
        engine.step()
        lens.append(int(engine.caches["len"][0, r2.slot]))
    # the fifth chunk completes the prompt: r2 joins that step's decode
    assert lens == [4, 8, 12, 16, 21], lens
    engine.run_until_done()
    assert set(engine.caches) >= {"c_kv", "k_rope"}
    assert r1.output == _solo(cfg, params, r1.prompt, 12, chunk=4)[0]
    assert r2.output == _solo(cfg, params, r2.prompt, 4, chunk=4)[0]
    alloc = engine.scheduler.allocator
    assert alloc.num_free == engine.kv.num_blocks - 1 and alloc.num_held == 0


def test_engine_on_card_matches_cpu(port):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cfg, params = port
    reqs = [Request(rid=i, prompt=[3 + i, 1, 4, 1, 5], max_new_tokens=6)
            for i in range(3)]
    engine = DecodeEngine(cfg, params, max_slots=2, max_context=MAX_CONTEXT,
                          block_size=BLOCK, prefill_chunk=CHUNK,
                          device="cuda")
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    for r in reqs:
        out, lps = _solo(cfg, params, r.prompt, 6)
        assert r.output == out
        np.testing.assert_allclose(r.logprobs, lps, atol=0.05)
