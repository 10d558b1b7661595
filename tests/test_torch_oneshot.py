"""The one-shot serving API of every family on the CPU
(``api.prefill_fn`` / ``decode_fn`` / ``cache_specs``, ``train.steps``'
``build_prefill_step`` / ``build_serve_step``) against the reference on
the reference's own parameters (reduced configs, seeded batches), and
the pieces the hybrid and audio families add: ``gqa_prefill`` over int8
and fp8 pools, ``attend_cache`` and ``sinusoidal_positions``.

Tolerances and their reasons:

* logits: the reference's own prefill-vs-decode bound (atol 0.25, rtol
  0.05, tests/test_models_smoke.py ``test_prefill_decode_parity``). The
  reduced configs' stacked ``fan_in`` init (the leading axis of a layer
  stack is the number of layers) lets the bf16 residual stream grow to
  ~100, where one bf16 step is 0.5; the two stacks' products and norms
  sum in other orders, so their streams part by such steps (lm families
  at most 0.064 apart here, whisper's bf16 logits 0.12 on a scale of
  0.54);
* greedy tokens: equal, or the reference's logit at the port's token
  within ``TIE`` of its maximum (a near-tie of bf16 logits);
* cache rows: block tables and lengths bitwise; K / V entries within
  one storage step of their row's largest value at the first layer
  (its inputs are the same tokens), and every layer's within ``RTOL``
  in relative norm (single entries of deeper layers carry the streams'
  rounding); Mamba2 states as ``check_states`` says;
* ``sinusoidal_positions``: angles pos x inv_timescale carry the two exp
  implementations' ulps, so 4 x L x 2^-24 at length L.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY, get_config, reduced  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.models import api, attention, common, paged  # noqa: E402
from repro.train import steps  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.quant import core as tqcore  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

SEQ, BATCH = 64, 2
ATOL, RTOL = 0.25, 0.05
TIE = 0.25
LM_ARCHS = ["qwen1.5-0.5b", "deepseek-v2-236b", "mamba2-780m",
            "llava-next-mistral-7b"]
STORAGE_STEP = {"bf16": 2.0 ** -7, "int8": 1 / 127, "fp8": 1 / 8}

_CASES: dict = {}


def case(arch):
    """(reference cfg, params, port cfg, params, reference batch, port
    batch) for ``arch``, built once per module."""
    if arch not in _CASES:
        cfg = reduced(get_config(arch))
        params = common.init_params(api.schema(cfg), jax.random.key(0))
        tcfg = t_reduced(t_get_config(arch))
        tparams = bridge.params_from_reference(
            jax.tree.map(np.asarray, params), device="cpu", cfg=tcfg)
        batch = synthetic.make_batch(cfg, SEQ, BATCH, kind="prefill", seed=3)
        tbatch = {k: bridge.from_numpy(np.asarray(v), "cpu")
                  for k, v in batch.items()}
        _CASES[arch] = (cfg, params, tcfg, tparams, batch, tbatch)
    return _CASES[arch]


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(bridge.to_numpy(got),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def assert_greedy(tokens, ref_logits):
    """The port's greedy tokens [B] against the reference's logits:
    equal, or a near-tie of the reference's within ``TIE``."""
    lg = np.asarray(ref_logits, np.float32)
    tok = np.asarray(tokens).reshape(-1)
    picked = lg[np.arange(len(tok)), tok]
    assert (picked >= lg.max(-1) - TIE).all(), (tok, lg.argmax(-1))


def _values(a) -> np.ndarray:
    """Pool entries as f32 (fp8 pools hold e4m3 bits as uint8)."""
    a = np.asarray(a)
    if a.dtype == np.uint8:
        return tqcore.cast_f32(torch.from_numpy(a)).numpy()
    return a.astype(np.float32)


def check_kv_pools(port: dict, ref: dict, kv_dtype: str = "bf16",
                   first_layer: bool = True):
    """Paged cache rows: tables and lengths bitwise; layer 0's entries
    within one storage step of their row's largest value (when
    ``first_layer``: its inputs are the prompt's own tokens); every
    layer's within ``RTOL`` in relative norm."""
    np.testing.assert_array_equal(port["block_table"], ref["block_table"])
    np.testing.assert_array_equal(port["len"], ref["len"])
    for name, scale in (("kpool", "kscale"), ("vpool", "vscale"),
                        ("c_kv", "c_kv_scale"), ("k_rope", "k_rope_scale")):
        if name not in ref:
            continue
        a, e = _values(port[name]), _values(ref[name])
        if scale in ref:
            a = a * np.asarray(port[scale])[..., None]
            e = e * np.asarray(ref[scale])[..., None]
        step = STORAGE_STEP[kv_dtype] * np.abs(e).max(-1, keepdims=True)
        assert not first_layer or (np.abs(a[0] - e[0])
                                   <= step[0] + 1e-6).all(), name
        for al, el in zip(a, e):
            assert np.linalg.norm(al - el) <= RTOL * np.linalg.norm(el), name


def check_states(port: dict, ref: dict):
    """Mamba2 caches [layers, ...]: layer 0's conv window within one bf16
    step of its largest entry; every layer's state and window within
    ``RTOL`` of the reference's in relative norm (a state sums a whole
    prompt's bf16-rounded inputs, so single entries carry the streams'
    rounding; 0.007 here)."""
    step = 2.0 ** -7 * np.abs(ref["conv"][0]).max()
    assert np.abs(port["conv"][0] - ref["conv"][0]).max() <= step
    for k in ("ssm", "conv"):
        for a, e in zip(port[k], ref[k]):
            assert np.linalg.norm(a - e) <= RTOL * np.linalg.norm(e), k


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_matches_reference(arch):
    """``lm_prefill`` of dense, MoE / MLA (first_k_dense), ssm and vlm
    (image patches prefixing the tokens): logits and caches."""
    cfg, params, tcfg, tparams, batch, tbatch = case(arch)
    logits, caches = jax.jit(api.prefill_fn(cfg, SEQ + 8))(params, batch)
    tlogits, tcaches = tapi.prefill_fn(tcfg, SEQ + 8)(tparams, tbatch)
    assert tlogits.dtype == torch.float32
    close(tlogits, logits)
    ref = bridge.caches_to_numpy(bridge.caches_from_reference(
        jax.tree.map(np.asarray, caches), device="cpu"))
    port = bridge.caches_to_numpy(tcaches)
    assert {k: v.shape for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}
    if cfg.family == "ssm":
        check_states(port, ref)
    else:
        check_kv_pools(port, ref)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_prefill_decode_parity(arch):
    """tests/test_models_smoke.py's contract inside the port, every
    family, on that test's parameters (``jax.random.key(0)``) and batch:
    the logits of position L from prefill(L) and from prefill(L - 1) +
    one decode step agree. (MoE capacity drops depend on the weights: on
    the port's own seed-0 draws olmoe's last token is routed otherwise
    in the 128-token prefill than in decode.)"""
    _, _, cfg, params, _, batch = case(arch)
    full, _ = tapi.prefill_fn(cfg, SEQ + 8)(params, batch)
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    _, caches = tapi.prefill_fn(cfg, SEQ + 8)(params, short)
    step = tapi.decode_fn(cfg)(params, batch["tokens"][:, -1:], caches)
    close(step, bridge.to_numpy(full))


def _ref_specs(tree):
    """Reference specs -> {leaf: (*shape, dtype name)}, an lm family's
    per-stack tuple concatenated along the layer axis."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return {k: (sum(t[k].shape[0] for t in tree), *tree[0][k].shape[1:],
                    jnp.dtype(tree[0][k].dtype).name) for k in tree[0]}
    if isinstance(tree, dict):
        return {k: _ref_specs(v) for k, v in tree.items()}
    return (*tree.shape, jnp.dtype(tree.dtype).name)


def _port_specs(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _port_specs(v) for k, v in tree.items()}
    return (*tree[0], str(tree[1]).split(".")[-1])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_cache_specs_match_reference(arch, kv_dtype):
    """Every leaf's shape and dtype, and the bytes per cached token (the
    hybrid's shared block has bf16 pools whatever kv_dtype says, in both
    stacks)."""
    cfg = reduced(get_config(arch)).with_(kv_dtype=kv_dtype)
    tcfg = t_reduced(t_get_config(arch)).with_(kv_dtype=kv_dtype)
    assert _port_specs(tapi.cache_specs(tcfg, 3, 40, num_blocks=9)) == \
        _ref_specs(api.cache_specs(cfg, 3, 40, num_blocks=9))
    assert tapi.KVCache.build(tcfg, max_context=40,
                              num_blocks=9).token_bytes() == \
        api.KVCache.build(cfg, max_context=40, num_blocks=9).token_bytes()


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-780m",
                                  "zamba2-1.2b", "whisper-tiny"])
def test_build_steps_tokens(arch):
    """``build_prefill_step`` then two ``build_serve_step`` steps, fed
    the reference's tokens: greedy tokens equal up to near-ties."""
    cfg, params, tcfg, tparams, batch, tbatch = case(arch)
    toks, caches = jax.jit(steps.build_prefill_step(cfg, SEQ + 8))(params,
                                                                   batch)
    ttoks, tcaches = tsteps.build_prefill_step(tcfg, SEQ + 8)(tparams, tbatch)
    assert ttoks.dtype == torch.int32 and ttoks.shape == (BATCH,)
    logits, _ = jax.jit(api.prefill_fn(cfg, SEQ + 8))(params, batch)
    assert_greedy(ttoks, logits)
    decode = jax.jit(api.decode_fn(cfg))
    serve = tsteps.build_serve_step(tcfg)
    cur = toks[:, None]
    for _ in range(2):
        ref_logits, caches = decode(params, cur, caches)
        nxt, tcaches = serve(tparams, tcaches, bridge.from_numpy(
            np.asarray(cur), "cpu"))
        assert nxt.shape == (BATCH, 1) and nxt.dtype == torch.int32
        assert_greedy(nxt, ref_logits)
        cur = jnp.argmax(ref_logits, -1).astype(jnp.int32)[:, None]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_gqa_prefill_matches_reference(kv_dtype):
    """The one-shot GQA prefill on the same inputs: output, and the
    (quantized) pools within one storage step of each row's largest
    value; identity tables and lengths bitwise."""
    rng = np.random.default_rng(7)
    acfg = attention.AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16,
                                q_chunk=16, kv_chunk=16, kv_dtype=kv_dtype)
    tcfg = tattention.AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16,
                                 q_chunk=16, kv_chunk=16, kv_dtype=kv_dtype)
    p = {k: (rng.standard_normal((64, 64)) / 8).astype(np.float32)
         for k in ("wq", "wk", "wv", "wo")}
    p["wk"], p["wv"] = p["wk"][:, :32], p["wv"][:, :32]
    x = jnp.asarray(rng.standard_normal((2, 40, 64)), jnp.bfloat16)
    layout = paged.PagedLayout(16, 3)
    out, cache = attention.gqa_prefill({k: jnp.asarray(v) for k, v in
                                        p.items()}, x, acfg, layout)
    tout, tcache = tattention.gqa_prefill(
        {k: torch.from_numpy(v) for k, v in p.items()},
        bridge.from_numpy(np.asarray(x), "cpu"), tcfg, layout)
    np.testing.assert_allclose(bridge.to_numpy(tout),
                               np.asarray(out, np.float32),
                               atol=4 * 2.0 ** -7 * np.abs(
                                   np.asarray(out, np.float32)).max())
    ref = bridge.caches_to_numpy(bridge.caches_from_reference(
        jax.tree.map(np.asarray, cache), device="cpu"))
    port = bridge.caches_to_numpy(tcache)
    check_kv_pools({k: v[None] for k, v in port.items()},
                   {k: v[None] for k, v in ref.items()}, kv_dtype)


def test_attend_cache_matches_reference():
    rng = np.random.default_rng(8)
    q = jnp.asarray(rng.standard_normal((3, 1, 6, 16)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((3, 50, 3, 16)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((3, 50, 3, 16)), jnp.bfloat16)
    lens = np.array([50, 1, 33], np.int32)
    want = np.asarray(attention.attend_cache(q, k, v, jnp.asarray(lens)),
                      np.float32)
    got = tattention.attend_cache(*(bridge.from_numpy(np.asarray(a), "cpu")
                                    for a in (q, k, v)),
                                  torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 1, 6, 16)
    # bf16 outputs: one bf16 step of the largest value
    np.testing.assert_allclose(bridge.to_numpy(got), want,
                               atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("length,dim", [(1500, 384), (64, 64)])
def test_sinusoidal_positions(length, dim):
    want = np.asarray(common.sinusoidal_positions(length, dim))
    got = tcommon.sinusoidal_positions(length, dim).numpy()
    assert got.shape == (length, dim) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 4 * length * 2.0 ** -24
