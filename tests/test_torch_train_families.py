"""Port parity of the training forms of every family beyond dense GQA and
Mamba2: MoE with GQA attention (olmoe-1b-7b), MLA + MoE with a leading
dense layer (deepseek-v2-236b), the hybrid (zamba2-1.2b), the
encoder-decoder (whisper-tiny) and the vlm (llava-next-mistral-7b), each
on its reduced config (2 layers, d_model 64, vocab 256; a vlm batch is
8 image patches then 24 text tokens), with the reference's own
parameters crossing through ``repro_torch.bridge`` as f32 masters
(``hold_bf16=False``).

Why tolerances, and how large: as in tests/test_torch_train.py, the port
computes what the reference computes (bf16 operands and cotangents, f32
products and sums) in another order, so bf16 roundings flip now and then;
the reference's gradients are compiled with ``xla_allow_excess_precision``
off, which keeps its bf16 roundings. Measured on these seeds: losses
within 3.8e-5 relative; gradient leaves within 2.3e-2 relative norm
error, except zamba2's tail ``dt_bias`` at 4.1e-2 (its gradient sums
signed terms over every position and head, and cancels); 3 trainer
steps pass at 2e-3. The MoE routers agree on every top-k choice here (a
top-k near-tie would send a token to another expert and move its
gradients by O(1)); the seeds are pinned so none sits at one.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.models import api, common  # noqa: E402
from repro.train.loop import Trainer as RefTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core.kahan import tree_leaves  # noqa: E402
from repro_torch.data import synthetic as tsynthetic  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.optim import accumulate as tacc  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402

ARCHS = ("olmoe-1b-7b", "deepseek-v2-236b", "zamba2-1.2b", "whisper-tiny",
         "llava-next-mistral-7b")
SEQ, BATCH = 32, 4
LOSS_RTOL = 1e-4
GRAD_RTOL = 6e-2
TRAINER_RTOL = 2e-3
# small aux metrics (a z-loss of ~1e-3) and exact zeros: an absolute floor
METRIC_ATOL = 1e-6


def _stack(tree):
    """Port tree (per-layer lists) -> numpy tree of the reference's
    stacked shape."""
    if isinstance(tree, dict):
        return {k: _stack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return jax.tree.map(lambda *a: np.stack(a), *map(_stack, tree))
    return bridge.to_numpy(tree)


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)
                                if v.dtype == jnp.bfloat16
                                else np.array(v)) for k, v in batch.items()}


def _bridged(params):
    return bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                        "cpu", hold_bf16=False)


def _ref_params(cfg):
    params = common.init_params(api.schema(cfg), jax.random.key(0))
    if "lora" in params:
        # the reference inits the LoRA b_* at zero; draw them so the
        # folded update and the a_* gradients are not trivially zero
        rng = np.random.default_rng(5)
        params["lora"] = {
            k: (jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32)
                if k.startswith("b_") else v)
            for k, v in params["lora"].items()}
    return params


_SETUP = {}


def _setup(arch):
    if arch not in _SETUP:
        cfg = reduced(get_config(arch))
        tcfg = t_reduced(t_get_config(arch))
        params = _ref_params(cfg)
        batch = synthetic.make_batch(cfg, SEQ, BATCH, seed=3)
        grad_fn = jax.jit(jax.value_and_grad(api.loss_fn(cfg), has_aux=True))
        compiled = grad_fn.lower(params, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})
        (loss, metrics), grads = compiled(params, batch)
        _SETUP[arch] = (cfg, tcfg, params, batch, loss, metrics, grads)
    return _SETUP[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_bitwise_reference(arch):
    """Training batches, image patches and audio frames included, are the
    reference's bits; ``split_microbatches`` splits every leaf."""
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    want = synthetic.make_batch(cfg, SEQ, BATCH, seed=11)
    got = tsynthetic.make_batch(tcfg, SEQ, BATCH, seed=11)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32)
                                      if v.dtype == jnp.bfloat16
                                      else np.asarray(v))
    micro = tacc.split_microbatches({k: torch.from_numpy(v)
                                     for k, v in got.items()}, 2)
    for k, v in micro.items():
        assert v.shape == (2, BATCH // 2) + got[k].shape[1:]
        assert torch.equal(v.reshape(got[k].shape), torch.from_numpy(got[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_metrics_match_reference(arch):
    _, tcfg, params, batch, loss, metrics, _ = _setup(arch)
    tloss, tmetrics = tapi.loss_fn(tcfg)(_bridged(params), _tbatch(batch))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=LOSS_RTOL)
    assert set(tmetrics) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), float(v),
                                   rtol=LOSS_RTOL, atol=METRIC_ATOL,
                                   err_msg=k)
    logits, aux = tapi.forward_fn(tcfg)(_bridged(params), _tbatch(batch))
    assert logits.dtype == torch.bfloat16
    assert logits.shape == (BATCH, SEQ, tcfg.vocab_size)
    assert set(aux) == ({"moe_load_balance", "moe_z_loss",
                         "moe_drop_fraction"}
                        if tcfg.family not in ("hybrid", "audio") else set())


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    """Every gradient leaf against ``jax.grad`` by relative norm error,
    bf16 products and cotangents on both sides."""
    _, tcfg, params, batch, loss, _, grads = _setup(arch)
    (tloss, _), tgrads = tacc.value_and_grad(tapi.loss_fn(tcfg),
                                             _bridged(params),
                                             _tbatch(batch))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=LOSS_RTOL)
    got = _stack(tgrads)
    errs = {}
    for path, want in jax.tree_util.tree_flatten_with_path(grads)[0]:
        node = got
        for k in path:
            node = node[k.key]
        want = np.asarray(want, np.float32)
        assert node.dtype == want.dtype and node.shape == want.shape
        assert np.linalg.norm(want) > 0, jax.tree_util.keystr(path)
        errs[jax.tree_util.keystr(path)] = (
            np.linalg.norm(node - want) / np.linalg.norm(want))
    assert len(errs) == len(jax.tree.leaves(got))
    assert max(errs.values()) < GRAD_RTOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_bit(arch):
    _, tcfg, params, batch, *_ = _setup(arch)
    outs = []
    for remat in (False, True):
        (loss, _), grads = tacc.value_and_grad(
            tapi.loss_fn(tcfg.with_(remat=remat)), _bridged(params),
            _tbatch(batch))
        outs.append((loss, tree_leaves(grads)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_reference_losses(arch):
    """3 steps of the port's ``Trainer`` (2 microbatches, Kahan
    accumulation and carry, fused gradient statistics) from the
    reference ``Trainer``'s own initial parameters."""
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    kw = dict(seq_len=SEQ, global_batch=BATCH, n_microbatches=2, seed=0)
    ref = RefTrainer(cfg, **kw)
    ref.init_state()
    start = _bridged(ref.params)
    want = [h["loss"] for h in ref.run(3, log_every=0)["history"]]
    t = Trainer(tcfg, device="cpu", **kw)
    t.params = start
    t.opt_state = adamw.init(t.params, t.opt_cfg)
    hist = t.run(3, log_every=0)["history"]
    np.testing.assert_allclose([h["loss"] for h in hist], want,
                               rtol=TRAINER_RTOL)
    text = SEQ - (cfg.vlm.num_patches if cfg.vlm is not None else 0)
    for h in hist:
        m = h["metrics"]
        assert {"grad_norm", "grad_maxabs", "lr_scale", "ce_loss",
                "tokens"} <= set(m)
        assert np.isfinite(float(m["grad_norm"]))
        # per microbatch, averaged: a vlm's image positions weigh 0
        assert float(m["tokens"]) == BATCH // 2 * text
    assert t.step == 3


def test_vlm_patch_positions_carry_zero_weight():
    """A vlm batch's labels at its image positions move neither the loss
    nor any gradient: their weights are 0."""
    cfg, tcfg, params, batch, *_ = _setup("llava-next-mistral-7b")
    p = cfg.vlm.num_patches
    tb = _tbatch(batch)
    assert tb["tokens"].shape == (BATCH, SEQ - p)
    assert tb["patch_embeds"].shape == (BATCH, p, cfg.vlm.vision_dim)
    assert not tb["weights"][:, :p].any() and tb["weights"][:, p:].all()
    moved = dict(tb, labels=tb["labels"].clone())
    moved["labels"][:, :p] = (moved["labels"][:, :p] + 17) % cfg.vocab_size
    outs = [tacc.value_and_grad(tapi.loss_fn(tcfg), _bridged(params), b)
            for b in (tb, moved)]
    assert torch.equal(outs[0][0][0], outs[1][0][0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(outs[0][1]),
                                                 tree_leaves(outs[1][1])))


def test_restart_bitwise_hybrid(tmp_path):
    """zamba2 (reduced): 3 steps with a checkpoint every step against 2
    steps, a 'crash', a restore into a fresh Trainer and 1 more: params
    and optimizer state bitwise equal."""
    tcfg = t_reduced(t_get_config("zamba2-1.2b"))
    kw = dict(seq_len=16, global_batch=4, n_microbatches=2, ckpt_every=1,
              seed=3, device="cpu")
    full = Trainer(tcfg, ckpt_dir=str(tmp_path / "full"), **kw)
    full.run(3, log_every=0)
    a = Trainer(tcfg, ckpt_dir=str(tmp_path / "ab"), **kw)
    a.run(2, log_every=0)
    del a
    b = Trainer(tcfg, ckpt_dir=str(tmp_path / "ab"), **kw)
    assert b.maybe_restore() and b.step == 2
    b.run(1, log_every=0)
    want = tree_leaves({"p": full.params, "o": full.opt_state})
    got = tree_leaves({"p": b.params, "o": b.opt_state})
    assert len(want) == len(got)
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(want, got))
