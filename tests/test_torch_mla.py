"""Port parity of the MLA + MoE serving model: reduced deepseek-v2
(``reduced(get_config("deepseek-v2-236b"))``: 2 layers = 1 leading dense
layer + 1 MoE layer, d_model 64, 4 MLA heads, kv_lora 16, rope 8, 8
experts top-2 + 2 shared, vocab 256) with the reference's own parameters
crossing through ``repro_torch.bridge``, for bf16, int8 and fp8 latent
pools.

Tolerances, and why: the port computes what the reference computes (bf16
operands, f32 products and sums, the same bf16 roundings) in another
summation order, so a bf16 rounding flips now and then and the flip
travels down the residual stream; logits agree to a few hundredths
(measured values beside each bound, on these seeds), latent pools to
one bf16 / quantization step in layer 0 and a few in layer 1. Routing
agrees exactly on these inputs; the prefill prompt is pinned to keep a
router near-tie out (see PREFILL_LOGIT_ATOL).

* the cache spec and ``token_bytes`` (1152 bytes per layer per token at
  full width in bf16);
* ``prefill_chunk``: logits and written latent pools vs the reference;
* ``decode`` vs the reference's KERNEL branch (the latent superkernel,
  which the port's decode runs; reached by monkeypatching
  ``paged_kernel_enabled``) from identical caches;
* a greedy rollout vs the reference's DEFAULT CPU path (plain masked
  softmax over the gathered, dequantized latents).
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import api, common, paged  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.quant import core as tq  # noqa: E402

ARCH = "deepseek-v2-236b"
DTYPES = ("bf16", "int8", "fp8")
BS, MAX_CONTEXT = 16, 64
SLOT = 1                      # slot 0 stays idle (null table)
ROW = np.arange(5, 9, dtype=np.int32)
POOLS = {"c_kv": "c_kv_scale", "k_rope": "k_rope_scale"}


def _cfgs(kv_dtype):
    return (reduced(get_config(ARCH)).with_(kv_dtype=kv_dtype),
            t_reduced(t_get_config(ARCH)).with_(kv_dtype=kv_dtype))


_PARAMS = {}


def _params(cfg):
    if not _PARAMS:
        p = common.init_params(api.schema(cfg), jax.random.key(0))
        _PARAMS["p"] = (p, bridge.params_from_reference(
            jax.tree.map(np.asarray, p), device="cpu"))
    return _PARAMS["p"]


def _fresh_caches(cfg, slots=2):
    kv = api.KVCache.build(cfg, max_context=MAX_CONTEXT, block_size=BS,
                           max_slots=slots)
    caches = paged.reset_slot(kv.init(slots), jnp.int32(SLOT),
                              jnp.asarray(ROW))
    return caches, bridge.caches_from_reference(
        jax.tree.map(np.asarray, caches), device="cpu")


def _prompt(n=29, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def _stacked(caches):
    """The reference's per-stack tuple -> one dict, layers concatenated."""
    return {k: np.concatenate([np.asarray(c[k]) for c in caches])
            for k in caches[0]}


def _deq(tree, name):
    """f32 view of a latent pool leaf (dequantized for int8/fp8)."""
    a = np.asarray(tree[name])
    if a.dtype.name == "bfloat16" or a.dtype == np.float32:
        return a.astype(np.float32)
    return tq.cast_f32(torch.from_numpy(np.array(a))).numpy() \
        * np.asarray(tree[POOLS[name]])[..., None]


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_cache_spec_and_token_bytes(kv_dtype):
    cfg, tcfg = _cfgs(kv_dtype)
    kv = api.KVCache.build(cfg, max_context=MAX_CONTEXT, max_slots=3)
    tkv = tapi.KVCache.build(tcfg, max_context=MAX_CONTEXT, max_slots=3)
    dense, main = kv.specs(3)
    spec = tkv.specs(3)
    assert set(dense) == set(main) == set(spec)
    for k, (shape, dtype) in spec.items():
        assert shape == (dense[k].shape[0] + main[k].shape[0],) \
            + tuple(main[k].shape[1:]), k
        assert np.dtype(main[k].dtype).itemsize == torch.empty(
            (), dtype=dtype).element_size(), k
    assert kv.token_bytes(3) == tkv.token_bytes(3)
    assert kv.num_blocks == tkv.num_blocks
    # full width: (kv_lora + rope) payload bytes (+ 2 f32 scales) per layer
    full = api.KVCache.build(get_config(ARCH).with_(kv_dtype=kv_dtype),
                             max_context=1024)
    tfull = tapi.KVCache.build(t_get_config(ARCH).with_(kv_dtype=kv_dtype),
                               max_context=1024)
    per_layer = {"bf16": 1152, "int8": 584, "fp8": 584}[kv_dtype]
    assert tfull.token_bytes() == full.token_bytes() == 60 * per_layer


# measured max |port - reference| logit deviation on prompt seed 3 (CPU):
# bf16 0.025, int8 0.019, fp8 0.030 — held at about 1.7x. The prompt is
# pinned (ROADMAP C, MoE routing margins): on seed 0 the 20th token's
# router logits carry a bf16 near-tie (5.094, 5.094, 5.031), XLA's jit
# and torch round the MoE layer's input one bf16 step apart, the top-2
# choice flips, and the bf16 logits move by 0.56.
PREFILL_LOGIT_ATOL = {"bf16": 0.05, "int8": 0.05, "fp8": 0.05}
# pools, max |port - reference| / max |reference| over both layers
POOL_REL_TOL = {"bf16": 0.03, "int8": 0.03, "fp8": 0.1}


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_prefill_chunk_parity(kv_dtype):
    cfg, tcfg = _cfgs(kv_dtype)
    params, tparams = _params(cfg)
    caches, tcaches = _fresh_caches(cfg)
    prompt = _prompt(seed=3)
    chunk = jax.jit(api.prefill_chunk_fn(cfg))
    tchunk = tapi.prefill_chunk_fn(tcfg)
    for pos0, c in ((0, 20), (20, 9)):                # two chunks
        toks = prompt[pos0:pos0 + c][None]
        lg, caches = chunk(params, jnp.asarray(toks), caches,
                           jnp.int32(SLOT), jnp.int32(pos0))
        tlg = tchunk(tparams, torch.from_numpy(toks), tcaches, SLOT, pos0)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg),
                                   atol=PREFILL_LOGIT_ATOL[kv_dtype],
                                   rtol=0)
    ref = _stacked(caches)
    got = bridge.caches_to_numpy(tcaches)
    np.testing.assert_array_equal(ref["len"], got["len"])
    np.testing.assert_array_equal(ref["block_table"], got["block_table"])
    blocks = ROW[:2]                   # the 29 written tokens' blocks
    for name in POOLS:
        want = _deq(ref, name)[:, blocks]
        have = _deq(got, name)[:, blocks]
        # layer 0 sees identical inputs: within one bf16 / quant step
        step = (2.0 ** -7 if kv_dtype == "bf16" else
                {"int8": 1 / 127, "fp8": 1 / 8}[kv_dtype])
        amax = np.abs(want[0]).max(axis=-1, keepdims=True)
        assert np.all(np.abs(have[0] - want[0]) <= step * amax + 1e-6), name
        amax = np.abs(want).max()
        assert np.abs(have - want).max() <= POOL_REL_TOL[kv_dtype] * amax, \
            name


# port decode vs the reference's kernel branch, from identical caches:
# measured max deviation bf16 0.027, int8 0.031, fp8 0.029 (prompt seed 0,
# prefilled by the reference in one chunk)
DECODE_LOGIT_ATOL = 0.05


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_decode_matches_reference_kernel_branch(monkeypatch, kv_dtype):
    from repro.models import attention

    cfg, tcfg = _cfgs(kv_dtype)
    params, tparams = _params(cfg)
    caches, _ = _fresh_caches(cfg)
    prompt = _prompt()
    _, caches = jax.jit(api.prefill_chunk_fn(cfg))(
        params, jnp.asarray(prompt[None]), caches, jnp.int32(SLOT),
        jnp.int32(0))
    tcaches = bridge.caches_from_reference(jax.tree.map(np.asarray, caches),
                                           device="cpu")
    toks = np.array([[0], [int(prompt[-1])]], np.int32)
    monkeypatch.setattr(attention, "paged_kernel_enabled", lambda: True)
    lg, new = jax.jit(api.decode_fn(cfg))(params, jnp.asarray(toks), caches)
    tlg = tapi.decode_fn(tcfg)(tparams, torch.from_numpy(toks), tcaches)
    np.testing.assert_allclose(tlg.numpy()[SLOT], np.asarray(lg)[SLOT],
                               atol=DECODE_LOGIT_ATOL, rtol=0)
    ref = bridge.caches_to_reference(tcaches, cfg.first_k_dense)
    for want, got in zip(new, ref):
        np.testing.assert_array_equal(np.asarray(want["len"]), got["len"])
        # the appended token (position 29 of the slot, block ROW[1], row 13)
        for name in POOLS:
            w = _deq(want, name)[:, ROW[1], 29 - BS]
            h = _deq(got, name)[:, ROW[1], 29 - BS]
            assert np.abs(h - w).max() <= POOL_REL_TOL[kv_dtype] \
                * np.abs(w).max(), name


def _rollout_reference(cfg, params, prompt, steps):
    caches, _ = _fresh_caches(cfg)
    lg, caches = jax.jit(api.prefill_chunk_fn(cfg))(
        params, jnp.asarray(prompt[None]), caches, jnp.int32(SLOT),
        jnp.int32(0))
    decode = jax.jit(api.decode_fn(cfg))
    rows = [np.asarray(lg[0])]
    for _ in range(steps - 1):
        toks = np.zeros((1 + SLOT, 1), np.int32)
        toks[SLOT] = rows[-1].argmax()
        lg, caches = decode(params, jnp.asarray(toks), caches)
        rows.append(np.asarray(lg[SLOT]))
    return rows


def _rollout_port(tcfg, tparams, cfg, prompt, steps):
    _, tcaches = _fresh_caches(cfg)
    lg = tapi.prefill_chunk_fn(tcfg)(tparams, torch.from_numpy(prompt[None]),
                                     tcaches, SLOT, 0)
    rows = [lg[0].numpy()]
    for _ in range(steps - 1):
        toks = torch.zeros((1 + SLOT, 1), dtype=torch.int32)
        toks[SLOT] = int(rows[-1].argmax())
        rows.append(tapi.decode_fn(tcfg)(tparams, toks, tcaches)[SLOT]
                    .numpy())
    return rows


# max |port - reference default path| logit deviation over the 8-step
# rollout, measured on this prompt: bf16 0.056, int8 0.094, fp8 0.127.
# The decode formulations differ (compensated latent superkernel vs a
# plain softmax over bf16-dequantized latents), so this exceeds the
# module-level deviations. The reference's smallest top-2 logit gap along
# the stream is 0.117 (bf16), 0.115 (int8), 0.036 (fp8): greedy equality
# rests on the deviation of the top-2 difference staying below that.
ROLLOUT_LOGIT_DEV = {"bf16": 0.1, "int8": 0.15, "fp8": 0.2}


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_greedy_rollout_equals_reference_default_path(kv_dtype):
    cfg, tcfg = _cfgs(kv_dtype)
    params, tparams = _params(cfg)
    prompt = _prompt(n=11, seed=4)
    ref = _rollout_reference(cfg, params, prompt, 8)
    got = _rollout_port(tcfg, tparams, cfg, prompt, 8)
    ref_toks = [int(r.argmax()) for r in ref]
    got_toks = [int(r.argmax()) for r in got]
    dev = max(float(np.abs(a - b).max()) for a, b in zip(ref, got))
    assert got_toks == ref_toks
    assert dev <= ROLLOUT_LOGIT_DEV[kv_dtype], dev
