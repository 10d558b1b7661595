"""The lm blocks follow ``cfg.act``: a GELU MLP in place of SwiGLU.

Reduced qwen1.5 (2 dense layers) and reduced deepseek-v2 (its
``first_k_dense`` MLA layer, then an MoE layer whose experts stay SwiGLU:
``cfg.act`` is the dense FFN's) with ``act="gelu"`` on both sides, the
reference's parameters carried across by ``bridge``. The tolerances are
the serving and training parity tests' own (tests/test_torch_model.py,
tests/test_torch_verify.py, tests/test_torch_train.py): the port sums in
another order than XLA, so logits agree to a few hundredths.

The reference runs with every bf16 rounding it writes: compiled with
``xla_allow_excess_precision`` off. By default
XLA's CPU jit drops the roundings of the GELU's input and output, which
moved the logits of these prompts by up to 0.16 from both the eager
reference and the port (measured: the port within 7.2e-07 of either
exact form), and so flipped greedy tokens on near-ties.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.models import api, common, paged  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402

QWEN, DSV2 = "qwen1.5-0.5b", "deepseek-v2-236b"
BS, MAX_CONTEXT, SLOT, C = 16, 64, 1, 5
ROW = np.arange(5, 9, dtype=np.int32)
# tests/test_torch_model.py (bf16 pools) and tests/test_torch_mla.py, on
# the latter's pinned prompt (seed 3): seed 0 carries a bf16 near-tie in
# the MoE router (ROADMAP queue C), with SwiGLU as with GELU
PREFILL_LOGIT_ATOL = {QWEN: 0.035, DSV2: 0.05}
PROMPT_SEED = 3
DECODE_LOGIT_ATOL = 0.05       # tests/test_torch_model.py
VERIFY_LOGIT_ATOL = 0.08       # tests/test_torch_verify.py
LOGPROB_ATOL = 0.05            # tests/test_torch_serving.py, bf16 pools
LOSS_RTOL = 5e-5               # tests/test_torch_train.py


def _cfgs(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), act="gelu")
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), act="gelu")
    return cfg, tcfg


_PARAMS = {}


def _params(cfg, hold_bf16=True):
    key = (cfg.name, hold_bf16)
    if key not in _PARAMS:
        p = common.init_params(api.schema(cfg), jax.random.key(0))
        _PARAMS[key] = (p, bridge.params_from_reference(
            jax.tree.map(np.asarray, p), device="cpu", hold_bf16=hold_bf16))
    return _PARAMS[key]


def _exact(fn, *args):
    """``fn(*args)`` jitted with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_allow_excess_precision": False})(*args)


def _prefilled(cfg, params, prompt):
    kv = api.KVCache.build(cfg, max_context=MAX_CONTEXT, block_size=BS,
                           max_slots=2)
    caches = paged.reset_slot(kv.init(2), jnp.int32(SLOT), jnp.asarray(ROW))
    return _exact(api.prefill_chunk_fn(cfg), params,
                  jnp.asarray(prompt[None]), caches, jnp.int32(SLOT),
                  jnp.int32(0))


def _port_caches(caches):
    return bridge.caches_from_reference(jax.tree.map(np.asarray, caches),
                                        device="cpu")


def _shapes(schema):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in schema.items()}


def test_the_port_accepts_every_act_the_reference_builds():
    """No family refuses an ``act`` any longer, and the port's schema is
    the reference's for either MLP."""
    for name in REGISTRY:
        for act in ("swiglu", "gelu"):
            dataclasses.replace(t_get_config(name), act=act).check_supported()
    for name in (QWEN, DSV2, "llava-next-mistral-7b"):
        cfg, tcfg = _cfgs(name)
        assert _shapes(tapi.schema(tcfg)) == _shapes(api.schema(cfg)), name


@pytest.mark.parametrize("arch", [QWEN, DSV2])
def test_gelu_serving_forms_match_reference(monkeypatch, arch):
    """Prefill chunk, decode (against the reference's superkernel branch,
    the port's formulation) and a verify window, from identical caches."""
    from repro.models import attention
    cfg, tcfg = _cfgs(arch)
    params, tparams = _params(cfg)
    assert set(tparams["dense_layers" if arch == DSV2 else "layers"][0]
               ["ffn"]) == {"w_up", "b_up", "w_down", "b_down"}
    prompt = np.random.default_rng(PROMPT_SEED).integers(0, 256, 29) \
        .astype(np.int32)
    kv = api.KVCache.build(cfg, max_context=MAX_CONTEXT, block_size=BS,
                           max_slots=2)
    fresh = paged.reset_slot(kv.init(2), jnp.int32(SLOT), jnp.asarray(ROW))
    tcaches = _port_caches(fresh)
    lg, caches = _prefilled(cfg, params, prompt)
    tlg = tapi.prefill_chunk_fn(tcfg)(tparams, torch.from_numpy(prompt[None]),
                                      tcaches, SLOT, 0)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg),
                               atol=PREFILL_LOGIT_ATOL[arch], rtol=0)

    monkeypatch.setattr(attention, "paged_kernel_enabled", lambda: True)
    toks = np.array([[0], [int(prompt[-1])]], np.int32)
    dlg, _ = _exact(api.decode_fn(cfg), params, jnp.asarray(toks), caches)
    tdlg = tapi.decode_fn(tcfg)(tparams, torch.from_numpy(toks),
                                _port_caches(caches))
    np.testing.assert_allclose(tdlg.numpy()[SLOT], np.asarray(dlg)[SLOT],
                               atol=DECODE_LOGIT_ATOL, rtol=0)

    win = np.random.default_rng(1).integers(0, 256, (1, C)).astype(np.int32)
    slots = np.array([SLOT], np.int32)
    pos0s = np.array([len(prompt)], np.int32)
    vlg, _ = _exact(api.verify_fn(cfg), params, jnp.asarray(win), caches,
                    jnp.asarray(slots), jnp.asarray(pos0s))
    tvlg = tapi.verify_fn(tcfg)(tparams, torch.from_numpy(win),
                                _port_caches(caches),
                                torch.from_numpy(slots),
                                torch.from_numpy(pos0s))
    np.testing.assert_allclose(tvlg.numpy(), np.asarray(vlg),
                               atol=VERIFY_LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tvlg.numpy().argmax(-1),
                                  np.asarray(vlg).argmax(-1))


def _reference_stream(cfg, params, prompt, n):
    """The reference's greedy stream and logprobs: a prefill chunk, then
    decode steps of slot ``SLOT``, every bf16 rounding kept."""
    lg, caches = _prefilled(cfg, params, np.asarray(prompt, np.int32))
    decode = None
    toks, lps = [], []
    row = np.asarray(lg)[0]
    for _ in range(n):
        tok = int(row.argmax())
        toks.append(tok)
        lps.append(float(jax.nn.log_softmax(row)[tok]))
        step = np.zeros((2, 1), np.int32)
        step[SLOT] = tok
        args = (params, jnp.asarray(step), caches)
        if decode is None:
            decode = jax.jit(api.decode_fn(cfg)).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        lg, caches = decode(*args)
        row = np.asarray(lg)[SLOT]
    return toks, lps


def test_gelu_greedy_streams_equal_reference():
    """The port's engine, three requests on two slots, against the
    reference's greedy stream of each prompt."""
    cfg, tcfg = _cfgs(QWEN)
    params, tparams = _params(cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, int(rng.integers(3, 30))).tolist()
               for _ in range(3)]
    got = [Request(rid=i, prompt=p, max_new_tokens=8)
           for i, p in enumerate(prompts)]
    engine = DecodeEngine(tcfg, tparams, device="cpu", max_slots=2,
                          max_context=MAX_CONTEXT, block_size=BS,
                          prefill_chunk=32)
    for r in got:
        engine.submit(r)
    engine.run_until_done()
    for p, g in zip(prompts, got):
        toks, lps = _reference_stream(cfg, params, p, 8)
        assert g.done and g.output == toks, (g.rid, toks, g.output)
        np.testing.assert_allclose(g.logprobs, lps, atol=LOGPROB_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("arch", [QWEN, DSV2])
def test_gelu_loss_matches_reference(arch):
    cfg, tcfg = _cfgs(arch)
    params, tparams = _params(cfg, hold_bf16=False)
    batch = synthetic.make_batch(cfg, 32, 4, seed=3)
    loss, _ = _exact(api.loss_fn(cfg), params, batch)
    tloss, _ = tapi.loss_fn(tcfg)(tparams, {
        k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert np.isfinite(float(tloss))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=LOSS_RTOL)
