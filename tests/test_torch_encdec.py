"""The audio family (reduced whisper-tiny: 2 encoder + 2 decoder layers,
64 frames) on the CPU, against the reference on its own parameters: the
synthetic frames, the encoder layer by layer, and the one-shot prefill
and 4 greedy decode steps over bf16 and int8 self-attention pools; at
full width, the encoder's layers from the same inputs.

Tolerances: each encoder layer from the same inputs within one bf16 step
of its output's largest value; end to end tests/test_torch_oneshot.py's
bounds (the reference's prefill-vs-decode atol 0.25, rtol 0.05 on the
logits, here 0.12 apart on a scale of 0.54: the bf16 logits of the tied
head read a stream that the reduced init grows to ~100, where one bf16
step is 0.5; greedy tokens up to near-ties); the cross K / V, products
of the encoder memory, within ``RTOL`` in relative norm per layer.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.models import api, attention, common, encdec, mlp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.data import synthetic as tsynthetic  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.serving.engine import DecodeEngine  # noqa: E402
from test_torch_oneshot import (RTOL, assert_greedy,  # noqa: E402
                                check_kv_pools, close)

ARCH = "whisper-tiny"
SEQ, BATCH, STEPS = 16, 2, 4


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config(ARCH))
    params = common.init_params(api.schema(cfg), jax.random.key(0))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    batch = synthetic.make_batch(cfg, SEQ, BATCH, kind="prefill", seed=6)
    tbatch = {k: bridge.from_numpy(np.asarray(v), "cpu")
              for k, v in batch.items()}
    return cfg, params, t_reduced(t_get_config(ARCH)), tparams, batch, tbatch


def test_make_batch_matches_reference(setup):
    cfg, _, tcfg, _, _, _ = setup
    for kind in ("prefill", "train"):
        want = synthetic.make_batch(cfg, SEQ, BATCH, kind=kind, seed=6)
        got = tsynthetic.make_batch(tcfg, SEQ, BATCH, kind=kind, seed=6)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k],
                                          np.asarray(want[k], got[k].dtype))
    assert got["frames"].shape == (BATCH, cfg.encdec.enc_seq, cfg.d_model)


def test_encoder_layers_from_the_same_inputs(setup):
    cfg, params, tcfg, tparams, batch, _ = setup

    def same(want, got):
        w = np.asarray(want, np.float32)
        assert np.abs(bridge.to_numpy(got) - w).max() <= \
            2.0 ** -7 * np.abs(w).max()

    h = batch["frames"].astype(jnp.bfloat16)
    h = h + common.sinusoidal_positions(h.shape[1], cfg.d_model).astype(
        h.dtype)[None]
    acfg, tacfg = encdec._acfg(cfg, causal=False), tencdec._acfg(
        tcfg, causal=False)
    for i, tlp in enumerate(tparams["enc_layers"]):
        lp = jax.tree.map(lambda x: x[i], params["enc_layers"])
        x = common.apply_norm(h, lp["ln_attn"], cfg.norm)
        tx = bridge.from_numpy(np.asarray(x), "cpu")
        same(x, tcommon.apply_norm(bridge.from_numpy(np.asarray(h), "cpu"),
                                   tlp["ln_attn"], tcfg.norm))
        y = attention.gqa_forward(lp["attn"], x, acfg)
        same(y, tattention.gqa_forward(tlp["attn"], tx, tacfg))
        h = h + y
        x = common.apply_norm(h, lp["ln_mlp"], cfg.norm)
        y = mlp.mlp_forward(lp["ffn"], x, act="gelu")
        same(y, tmlp.mlp_forward(tlp["ffn"], bridge.from_numpy(
            np.asarray(x), "cpu"), act="gelu"))
        h = h + y


def test_full_width_encoder_layers_from_the_same_inputs():
    """whisper-tiny at full width (d 384, 6 heads, 1500 frames, one
    sequence): each encoder layer's attention and MLP from the same
    inputs within a relative distance of 2^-9 (half a bf16 step; the
    readings are 2e-4 to 5e-4: the two stacks sum in other orders and
    round each element once). The free-running streams part further at
    every layer, printed: the reference's ``fan_in`` init scales the
    stacked leaves by 1 / sqrt(layers), which grows the stream to ~1700
    (one bf16 step is 8 there), and each layer carries a difference on
    some 3-10x; so at full width two summation orders leave logits
    O(1) apart, and a full-width logit comparison gates nothing."""
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    params = common.init_params(api.schema(cfg), jax.random.key(0))
    enc = {"enc_layers": params["enc_layers"]}
    tenc = bridge.params_from_reference(jax.tree.map(np.asarray, enc),
                                        device="cpu")["enc_layers"]
    frames = synthetic.make_batch(cfg, 4, 1, kind="prefill",
                                  seed=6)["frames"]

    def dist(want, got):
        w = np.asarray(want, np.float32)
        return float(np.linalg.norm(bridge.to_numpy(got) - w)
                     / np.linalg.norm(w))

    h = frames.astype(jnp.bfloat16)
    h = h + common.sinusoidal_positions(h.shape[1], cfg.d_model).astype(
        h.dtype)[None]
    th = bridge.from_numpy(np.asarray(h), "cpu")
    acfg, tacfg = encdec._acfg(cfg, causal=False), tencdec._acfg(
        tcfg, causal=False)
    free = []
    for i, tlp in enumerate(tenc):
        lp = jax.tree.map(lambda x: x[i], params["enc_layers"])
        x = common.apply_norm(h, lp["ln_attn"], cfg.norm)
        y = attention.gqa_forward(lp["attn"], x, acfg)
        assert dist(y, tattention.gqa_forward(tlp["attn"], bridge.from_numpy(
            np.asarray(x), "cpu"), tacfg)) <= 2.0 ** -9
        h = h + y
        x = common.apply_norm(h, lp["ln_mlp"], cfg.norm)
        y = mlp.mlp_forward(lp["ffn"], x, act="gelu")
        assert dist(y, tmlp.mlp_forward(tlp["ffn"], bridge.from_numpy(
            np.asarray(x), "cpu"), act="gelu")) <= 2.0 ** -9
        h = h + y
        tx = tcommon.apply_norm(th, tlp["ln_attn"], tcfg.norm)
        th = th + tattention.gqa_forward(tlp["attn"], tx, tacfg)
        tx = tcommon.apply_norm(th, tlp["ln_mlp"], tcfg.norm)
        th = th + tmlp.mlp_forward(tlp["ffn"], tx, act="gelu")
        free.append(dist(h, th))
    print(f"full-width encoder, free-running stream max |h| "
          f"{float(jnp.abs(h.astype(jnp.float32)).max()):.0f}, relative "
          f"distance after each layer: {[f'{d:.3g}' for d in free]}")
    assert all(np.isfinite(free))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_and_decode_match_reference(setup, kv_dtype):
    cfg, params, tcfg, tparams, batch, tbatch = setup
    cfg, tcfg = cfg.with_(kv_dtype=kv_dtype), tcfg.with_(kv_dtype=kv_dtype)
    logits, caches = jax.jit(api.prefill_fn(cfg, SEQ + 8))(params, batch)
    tlogits, tcaches = tapi.prefill_fn(tcfg, SEQ + 8)(tparams, tbatch)
    assert tlogits.dtype == torch.bfloat16
    close(tlogits, logits)
    assert_greedy(torch.argmax(tlogits, -1), logits)
    decode = jax.jit(api.decode_fn(cfg))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    for _ in range(STEPS):
        logits, caches = decode(params, tok, caches)
        tlogits = tapi.decode_fn(tcfg)(
            tparams, bridge.from_numpy(np.asarray(tok), "cpu"), tcaches)
        close(tlogits, logits)
        assert_greedy(torch.argmax(tlogits, -1), logits)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    ref = bridge.caches_to_numpy(bridge.caches_from_reference(
        jax.tree.map(np.asarray, caches), device="cpu"))
    port = bridge.caches_to_numpy(tcaches)
    check_kv_pools(port["self"], ref["self"], kv_dtype)
    assert np.all(port["self"]["len"] == SEQ + STEPS)
    for k in ("cross_k", "cross_v"):
        assert tcaches[k].dtype == torch.bfloat16
        for a, e in zip(port[k], ref[k]):
            assert np.linalg.norm(a - e) <= RTOL * np.linalg.norm(e), k


def test_engine_refuses(setup):
    _, _, tcfg, tparams, _, _ = setup
    with pytest.raises(NotImplementedError,
                       match="chunked prefill serves lm families"):
        DecodeEngine(tcfg, tparams, max_slots=2, max_context=64,
                     device="cpu")
