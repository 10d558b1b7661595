"""Port parity of the dense serving model: reduced qwen1.5 (2 layers,
d_model 64, vocab 256; MHA and a grouped num_kv_heads=2 variant) with
the reference's own parameters crossing through ``repro_torch.bridge``,
for bf16, int8 and fp8 KV pools.

Why tolerances, and how large: the port computes what the reference
computes (bf16 operands, f32 products and accumulation, one bf16
rounding per layer op) but sums in another order. An f32 order
difference flips a bf16 rounding now and then; one flipped element of
the residual stream shifts every downstream element a little, and a
shifted K value can land on the other side of an int8 or e4m3 rounding
step. So logits agree to a few hundredths (measured below, on this
seed), not bitwise, and quantized pools agree to one quantization step.

* ``prefill_chunk``: logits and written pools vs the reference;
* ``decode`` vs the reference's KERNEL branch (the superkernel, which is
  what the port's decode runs; reached by monkeypatching
  ``paged_kernel_enabled`` as tests/test_superkernel.py does), from
  identical caches, so only the step's own arithmetic differs;
* an 8-step greedy rollout vs the reference's DEFAULT CPU path (flash
  attention over dequantized rows): greedy tokens are equal, and the
  logit deviation stays under the stated bound.
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

DTYPES = ("bf16", "int8", "fp8")
BS, MAX_CONTEXT = 16, 64
SLOT = 1                      # slot 0 stays idle (null table)
ROW = np.arange(5, 9, dtype=np.int32)


def _cfgs(kv_dtype, kv_heads):
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(
        num_layers=2, kv_dtype=kv_dtype, num_kv_heads=kv_heads)
    tcfg = t_reduced(t_get_config("qwen1.5-0.5b")).with_(
        kv_dtype=kv_dtype, num_kv_heads=kv_heads)
    return cfg, tcfg


_PARAMS = {}


def _params(cfg):
    key = (cfg.num_kv_heads,)
    if key not in _PARAMS:
        p = common.init_params(api.schema(cfg), jax.random.key(0))
        _PARAMS[key] = (p, bridge.params_from_reference(
            jax.tree.map(np.asarray, p), device="cpu"))
    return _PARAMS[key]


def _fresh_caches(cfg, slots=2):
    kv = api.KVCache.build(cfg, max_context=MAX_CONTEXT, block_size=BS,
                           max_slots=slots)
    caches = paged.reset_slot(kv.init(slots), jnp.int32(SLOT),
                              jnp.asarray(ROW))
    return caches, bridge.caches_from_reference(
        jax.tree.map(np.asarray, caches), device="cpu")


def _prompt(n=29, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def _deq(tree, name):
    """f32 view of a pool leaf (dequantized for int8/fp8)."""
    a = np.asarray(tree[name])
    if a.dtype.name == "bfloat16" or a.dtype == np.float32:
        return a.astype(np.float32)
    scale = np.asarray(tree[name.replace("pool", "scale")])
    q = torch.from_numpy(np.array(a))
    return (tq.cast_f32(q).numpy() * scale[..., None])


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_cache_spec_and_token_bytes(kv_dtype):
    cfg, tcfg = _cfgs(kv_dtype, 2)
    kv = api.KVCache.build(cfg, max_context=MAX_CONTEXT, max_slots=3)
    tkv = tapi.KVCache.build(tcfg, max_context=MAX_CONTEXT, max_slots=3)
    (ref,) = kv.specs(3)
    spec = tkv.specs(3)
    assert set(ref) == set(spec)
    for k, s in ref.items():
        shape, dtype = spec[k]
        assert tuple(s.shape) == shape, k
        assert np.dtype(s.dtype).itemsize == torch.empty(
            (), dtype=dtype).element_size(), k
    assert kv.token_bytes(3) == tkv.token_bytes(3)
    assert kv.num_blocks == tkv.num_blocks


# measured max |port - reference| logit deviation on this seed (CPU):
# bf16 0.0204, int8 0.0332, fp8 0.0347 — held at about 1.7x
PREFILL_LOGIT_ATOL = {"bf16": 0.035, "int8": 0.06, "fp8": 0.06}
# pools, max |port - reference| / max |reference| over both layers:
# measured bf16 0.0072, int8 0.0087, fp8 0.0504
POOL_REL_TOL = {"bf16": 0.02, "int8": 0.02, "fp8": 0.1}


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_prefill_chunk_parity(kv_dtype, kv_heads):
    cfg, tcfg = _cfgs(kv_dtype, kv_heads)
    params, tparams = _params(cfg)
    caches, tcaches = _fresh_caches(cfg)
    prompt = _prompt()
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
    (ref,) = caches
    got = bridge.caches_to_numpy(tcaches)
    np.testing.assert_array_equal(np.asarray(ref["len"]), got["len"])
    np.testing.assert_array_equal(np.asarray(ref["block_table"]),
                                  got["block_table"])
    blocks = ROW[:2]                   # the 29 written tokens' blocks
    for name in ("kpool", "vpool"):
        want = _deq(ref, name)[:, blocks]
        have = _deq(got, name)[:, blocks]
        # layer 0 sees identical inputs: within one bf16 / quant step
        step = (2.0 ** -7 if kv_dtype == "bf16" else
                {"int8": 1 / 127, "fp8": 1 / 8}[kv_dtype])
        amax = np.abs(want[0]).max(axis=-1, keepdims=True)
        assert np.all(np.abs(have[0] - want[0]) <= step * amax + 1e-6), name
        # layer 1 inherits the residual stream's rounding flips
        amax = np.abs(want).max()
        assert np.abs(have - want).max() <= POOL_REL_TOL[kv_dtype] * amax, \
            name


# port decode vs the reference's kernel branch, from identical caches:
# measured max deviation 0.0332 (fp8, MHA)
DECODE_LOGIT_ATOL = 0.05


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_decode_matches_reference_kernel_branch(monkeypatch, kv_dtype,
                                                kv_heads):
    from repro.models import attention

    cfg, tcfg = _cfgs(kv_dtype, kv_heads)
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
    (ref,) = new
    got = bridge.caches_to_numpy(tcaches)
    np.testing.assert_array_equal(np.asarray(ref["len"]), got["len"])
    # the appended token (position 29 of the slot, block ROW[1], row 13)
    for name in ("kpool", "vpool"):
        want = _deq(ref, name)[:, ROW[1], 29 - BS]
        have = _deq(got, name)[:, ROW[1], 29 - BS]
        amax = np.abs(want).max()
        assert np.abs(have - want).max() <= POOL_REL_TOL[kv_dtype] * amax, \
            name


def _rollout_reference(cfg, params, prompt, steps):
    caches, _ = _fresh_caches(cfg, slots=1 + SLOT)
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
    _, tcaches = _fresh_caches(cfg, slots=1 + SLOT)
    lg = tapi.prefill_chunk_fn(tcfg)(tparams, torch.from_numpy(prompt[None]),
                                     tcaches, SLOT, 0)
    rows = [lg[0].numpy()]
    for _ in range(steps - 1):
        toks = torch.zeros((1 + SLOT, 1), dtype=torch.int32)
        toks[SLOT] = int(rows[-1].argmax())
        rows.append(tapi.decode_fn(tcfg)(tparams, toks, tcaches)[SLOT]
                    .numpy())
    return rows


# max |port - reference default path| logit deviation over the rollout,
# measured on this prompt: bf16 0.066, int8 0.103, fp8 0.118. The decode
# formulations differ (compensated superkernel vs flash attention over
# bf16-dequantized rows), so this exceeds the module-level deviations.
# The reference's smallest top-2 gap along the stream is 0.055 (bf16),
# 0.057 (int8), 0.103 (fp8): equality rests on the deviation of the
# top-2 difference staying below that, which is what the test pins; a
# prompt whose stream passes a closer near-tie can flip a token without
# any fault in the port.
ROLLOUT_LOGIT_DEV = {"bf16": 0.1, "int8": 0.15, "fp8": 0.2}


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_greedy_rollout_equals_reference_default_path(kv_dtype):
    cfg, tcfg = _cfgs(kv_dtype, 2)
    params, tparams = _params(cfg)
    prompt = _prompt(n=11, seed=4)
    ref = _rollout_reference(cfg, params, prompt, 8)
    got = _rollout_port(tcfg, tparams, cfg, prompt, 8)
    ref_toks = [int(r.argmax()) for r in ref]
    got_toks = [int(r.argmax()) for r in got]
    dev = max(float(np.abs(a - b).max()) for a, b in zip(ref, got))
    assert got_toks == ref_toks
    assert dev <= ROLLOUT_LOGIT_DEV[kv_dtype], dev


@pytest.mark.parametrize("which", ["dense", "expert_matmul"])
def test_bf16_held_weights_bitwise_f32_held(which):
    """The load paths hold the weights that only feed bf16 products as
    bf16 (``common.BF16_WEIGHTS``); ``dense`` and the MoE expert products
    on them are bitwise the same products on the f32 weights (rounding to
    bf16 is idempotent). The tree's shape and the f32 leaves stay."""
    from repro_torch.models import common as tcommon
    from repro_torch.models import moe as tmoe
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 5, 64, generator=g)
    if which == "dense":
        w = torch.randn(64, 48, generator=g)
        b = torch.randn(48, generator=g)
        got = tcommon.dense(x, w.to(torch.bfloat16), b)
        want = tcommon.dense(x, w, b)
    else:
        w = torch.randn(4, 64, 48, generator=g)
        got = tmoe._expert_matmul(x[:, :4].transpose(0, 1).contiguous(),
                                  w.to(torch.bfloat16))
        want = tmoe._expert_matmul(x[:, :4].transpose(0, 1).contiguous(), w)
    assert got.dtype == want.dtype and torch.equal(got, want)
    # both load paths hold exactly the listed weights as bf16
    cfg = t_reduced(t_get_config("qwen1.5-0.5b")).with_(num_layers=2)
    held = tapi.init_params(cfg, device="cpu", seed=0)
    f32 = tapi.init_params(cfg, device="cpu", seed=0, hold_bf16=False)
    ref = common.init_params(api.schema(reduced(get_config("qwen1.5-0.5b"))
                                        .with_(num_layers=2)),
                             jax.random.key(0))
    bridged = bridge.params_from_reference(jax.tree.map(np.asarray, ref),
                                           device="cpu")
    for tree in (held, bridged):
        for i, layer in enumerate(tree["layers"]):
            for grp, leaves in layer.items():
                for name, t in (leaves.items() if isinstance(leaves, dict)
                                else [(grp, leaves)]):
                    bf = name in tcommon.BF16_WEIGHTS
                    assert t.dtype == (torch.bfloat16 if bf
                                       else torch.float32), name
                    if tree is held:
                        assert torch.equal(
                            t, f32["layers"][i][grp][name].to(t.dtype))
        assert tree["lm_head"].dtype == tree["embed"].dtype == torch.float32
