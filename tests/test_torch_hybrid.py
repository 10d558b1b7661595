"""The hybrid family (reduced zamba2-1.2b: 5 Mamba2 layers in segments of
2, so a tail of 1, and the shared attention + MLP block after each
segment) on the CPU, against the reference on its own parameters with
the LoRA ``b_*`` leaves drawn nonzero (they initialise to zeros, which
would leave the fold nothing to do).

Each layer from the same inputs agrees within one bf16 step of its
output's largest value (the products and norms sum in other orders).
End to end, on the reference smoke tests' parameters (``key(0)``), the
logits are held at tests/test_torch_oneshot.py's bound (the reference's
prefill-vs-decode atol 0.25, rtol 0.05): the reduced init's residual
stream grows through the layers and carries those rounding differences
along, by how much depends on the weights (0.07 on a logit scale of 3.6
here; 0.82 on a scale of 3.0 from ``key(2)``, whose layers agree as
closely from the same inputs). Greedy tokens
equal up to a near-tie of the reference's bf16 logits (``TIE``); the
LoRA-folded weights within one bf16 step (the f32 rank-r products sum in
another order before the weight's rounding); Mamba2 states as
``test_torch_oneshot.check_states``.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.models import api, common, hybrid  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import hybrid as thybrid  # noqa: E402
from repro_torch.models.blocks import check_trainable  # noqa: E402
from repro_torch.serving.engine import DecodeEngine  # noqa: E402
from test_torch_oneshot import (ATOL, RTOL, assert_greedy,  # noqa: E402
                                check_kv_pools, check_states, close)

ARCH = "zamba2-1.2b"
SEQ, BATCH, STEPS = 48, 2, 4


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config(ARCH))
    params = common.init_params(api.schema(cfg), jax.random.key(0))
    rng = np.random.default_rng(5)
    params["lora"] = {k: (jnp.asarray(0.05 * rng.standard_normal(v.shape),
                                      jnp.float32) if k.startswith("b_")
                          else v) for k, v in params["lora"].items()}
    tcfg = t_reduced(t_get_config(ARCH))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu", cfg=tcfg)
    batch = synthetic.make_batch(cfg, SEQ, BATCH, kind="prefill", seed=4)
    tbatch = {"tokens": bridge.from_numpy(np.asarray(batch["tokens"]),
                                          "cpu")}
    return cfg, params, tcfg, tparams, batch, tbatch


def _ref_caches(caches):
    return bridge.caches_to_numpy(bridge.caches_from_reference(
        jax.tree.map(np.asarray, caches), device="cpu"))


def test_tree_and_lora_fold(setup):
    """The tree's stacks split per layer with a tail, the folded q / k / v
    weights held f32 until the fold, and the fold itself."""
    cfg, params, tcfg, tparams, _, _ = setup
    assert thybrid._segments(tcfg) == (2, 2, 1)
    assert len(tparams["mamba_blocks"]) == 4
    assert len(tparams["mamba_tail"]) == 1
    shared = tparams["shared"]["attn"]
    assert shared["wq"].dtype == torch.float32
    assert shared["wo"].dtype == torch.bfloat16
    for s in range(2):
        want = hybrid._lora_params(params, s)
        got = thybrid._lora_params(tparams, s)
        for name in ("wq", "wk", "wv"):
            w = np.asarray(want[name], np.float32)
            ref = np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)
            np.testing.assert_allclose(bridge.to_numpy(got[name]), ref,
                                       atol=2.0 ** -7 * np.abs(w).max())
            assert not np.array_equal(w, np.asarray(params["shared"]["attn"]
                                                    [name]))


def test_each_layer_from_the_same_inputs(setup):
    """Every Mamba2 layer, each shared-block call (the segment's folded
    LoRA, ``gqa_prefill``) and its MLP on the reference's own inputs,
    through the prefill."""
    from repro.models import attention, mlp, paged, ssd
    from repro_torch.models import attention as tattention
    from repro_torch.models import mlp as tmlp
    from repro_torch.models import paged as tpaged
    from repro_torch.models import ssd as tssd
    cfg, params, tcfg, tparams, batch, _ = setup

    def same(want, got):
        w = np.asarray(want, np.float32)
        assert np.abs(bridge.to_numpy(got) - w).max() <= \
            2.0 ** -7 * np.abs(w).max()

    def port(a):
        return bridge.from_numpy(np.asarray(a), "cpu")

    h = jnp.take(params["embed"], batch["tokens"], axis=0).astype(
        jnp.bfloat16)
    shared, tshared = params["shared"], tparams["shared"]
    for j in range(5):
        tail = j == 4
        lp = jax.tree.map(lambda x: x[0 if tail else j],
                          params["mamba_tail" if tail else "mamba_blocks"])
        tlp = tparams["mamba_tail"][0] if tail else \
            tparams["mamba_blocks"][j]
        x = common.apply_norm(h, lp["norm"], cfg.norm)
        y, _ = ssd.mamba2_forward(lp["mixer"], x, cfg.ssm, return_state=True)
        same(y, tssd.mamba2_forward(tlp["mixer"], port(x), tcfg.ssm))
        h = h + y
        if j % 2 == 1:
            x = common.apply_norm(h, shared["ln_attn"], cfg.norm)
            y, _ = attention.gqa_prefill(
                hybrid._lora_params(params, j // 2), x,
                hybrid._shared_attn_cfg(cfg), paged.as_layout(SEQ))
            same(y, tattention.gqa_prefill(
                thybrid._lora_params(tparams, j // 2), port(x),
                thybrid._shared_attn_cfg(tcfg), tpaged.as_layout(SEQ))[0])
            h = h + y
            x = common.apply_norm(h, shared["ln_mlp"], cfg.norm)
            y = mlp.mlp_forward(shared["ffn"], x, act=cfg.act)
            same(y, tmlp.mlp_forward(tshared["ffn"], port(x), act=tcfg.act))
            h = h + y


def test_prefill_and_decode_match_reference(setup):
    """``hybrid_prefill`` then ``STEPS`` greedy ``hybrid_decode`` steps
    (the reference's tokens fed to both): logits each step, greedy
    tokens, and the caches after the last step."""
    cfg, params, tcfg, tparams, batch, tbatch = setup
    logits, caches = jax.jit(api.prefill_fn(cfg, SEQ + 8))(params, batch)
    tlogits, tcaches = tapi.prefill_fn(tcfg, SEQ + 8)(tparams, tbatch)
    assert tlogits.dtype == torch.bfloat16
    close(tlogits, logits)
    assert tcaches["tail"]["ssm"].shape[0] == 1
    decode = jax.jit(api.decode_fn(cfg))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    assert_greedy(torch.argmax(tlogits, -1), logits)
    for _ in range(STEPS):
        logits, caches = decode(params, tok, caches)
        tlogits = tapi.decode_fn(tcfg)(
            tparams, bridge.from_numpy(np.asarray(tok), "cpu"), tcaches)
        close(tlogits, logits)
        assert_greedy(torch.argmax(tlogits, -1), logits)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    ref, port = _ref_caches(caches), bridge.caches_to_numpy(tcaches)

    def layers(c):            # [layer, ...]: the segments, then the tail
        return {k: np.concatenate([c["mamba"][k].reshape(
            (-1,) + c["tail"][k].shape[1:]), c["tail"][k]])
            for k in ("ssm", "conv")}

    check_states(layers(port), layers(ref))
    # the first block call reads the stream after two Mamba2 layers
    check_kv_pools(port["attn"], ref["attn"], first_layer=False)
    assert np.all(port["attn"]["len"] == SEQ + STEPS)


def test_quantized_pools_prefill_decode_parity(setup):
    """``kv_dtype="int8"`` leaves the shared block's pools bf16, as the
    reference's ``_shared_attn_cfg`` does: the prefill and a decode step
    are bitwise the bf16 config's, and prefill(L) agrees with
    prefill(L - 1) + one decode step within the reference's bound."""
    _, _, tcfg, tparams, _, tbatch = setup
    qcfg = tcfg.with_(kv_dtype="int8")
    full, _ = tapi.prefill_fn(qcfg, SEQ + 8)(tparams, tbatch)
    short = dict(tbatch, tokens=tbatch["tokens"][:, :-1])
    outs = []
    for c in (qcfg, tcfg):
        _, caches = tapi.prefill_fn(c, SEQ + 8)(tparams, short)
        assert caches["attn"]["kpool"].dtype == torch.bfloat16
        assert "kscale" not in caches["attn"]
        outs.append(tapi.decode_fn(c)(tparams, tbatch["tokens"][:, -1:],
                                      caches))
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(full, tapi.prefill_fn(tcfg, SEQ + 8)(tparams,
                                                            tbatch)[0])
    np.testing.assert_allclose(bridge.to_numpy(outs[0]),
                               bridge.to_numpy(full), atol=ATOL, rtol=RTOL)


def test_engine_and_trainer_refuse(setup):
    """The hybrid family serves through the one-shot API only: the
    engine refuses it with the reference's message, and so does the
    chunked prefill and the verify window; it trains (a finite loss
    from ``api.loss_fn``)."""
    _, _, tcfg, tparams, _, _ = setup
    with pytest.raises(NotImplementedError,
                       match="chunked prefill serves lm families"):
        DecodeEngine(tcfg, tparams, max_slots=2, max_context=64,
                     device="cpu")
    check_trainable(tcfg)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 16),
                                        dtype=np.int32))
    batch = {"tokens": tok, "labels": tok,
             "weights": torch.ones(tok.shape, dtype=torch.float32)}
    loss, metrics = tapi.loss_fn(tcfg)(tparams, batch)
    assert bool(torch.isfinite(loss)) and set(metrics) == {"ce_loss",
                                                           "tokens"}
    with pytest.raises(NotImplementedError, match="paged-KV"):
        tapi.verify_fn(tcfg)
