"""The port's registry (``repro_torch.configs``) against the reference's:
every config and every ``reduced()`` config field by field, the shape
cells, and three reduced families the port gained here served against
the reference on the reference's own parameters: stablelm-3b
(layernorm, 25% rotary), olmoe-1b-7b (MoE with GQA attention) and
llava-next-mistral-7b served text-only (as the serving CLI does), plus
the vlm projector's ``lm_forward`` with patch embeddings.

Tolerances: the prefill logits of a 2-layer reduced model differ by the
bf16 rounding flips of another f32 summation order (tests/
test_torch_model.py measured 0.02 on reduced qwen1.5): held at 0.05.
The decode rollout runs the reference's default CPU path (flash attention
over gathered rows) against the port's superkernel twin, two
formulations: held at test_torch_model.py's rollout bound for bf16
pools, 0.1, with equal greedy tokens (measured here: stablelm-3b 0.036,
llava 0.074). olmoe-1b-7b's rollout is held at 0.2: its router picks 2
of 8 experts from logits that carry the same noise, so a router near-tie
can send a token to another expert on one side (measured 0.138 at the
sixth step; its greedy tokens stay equal). The vlm forward's logits are bf16
(a training forward), compiled with ``xla_allow_excess_precision`` off
as tests/test_torch_train.py does: held at 0.05.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as R  # noqa: E402
from repro.models import api, common, lm, paged  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as P  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

# the reference's fields with no twin in the port, per config type (the
# port packs causal attention wherever ``causal_packing`` would, with the
# unpacked walk's bits: ``attention.flash_attention``)
REFERENCE_ONLY = {"ModelConfig": {"causal_packing"},
                  "MLAConfig": {"causal_packing"},
                  "MoEConfig": {"act"}}
LOGIT_ATOL = 0.05
DECODE_ATOL = {"stablelm-3b": 0.1, "llava-next-mistral-7b": 0.1,
               "olmoe-1b-7b": 0.2}
STEPS = 6


def _fields(c) -> dict:
    if hasattr(c, "_asdict"):
        return c._asdict()
    return {f: getattr(c, f) for f in c.__dataclass_fields__}


def _defaults(c) -> dict:
    if hasattr(c, "_field_defaults"):
        return c._field_defaults
    return {f.name: f.default for f in c.__dataclass_fields__.values()}


def _assert_same(ref, port, path="cfg"):
    if ref is None or port is None:
        assert ref is None and port is None, path
        return
    if not (hasattr(ref, "_asdict") or hasattr(ref,
                                               "__dataclass_fields__")):
        assert ref == port and type(ref) is type(port), (path, ref, port)
        return
    assert type(ref).__name__ == type(port).__name__, path
    rf, pf = _fields(ref), _fields(port)
    only = REFERENCE_ONLY.get(type(ref).__name__, set())
    assert set(rf) - set(pf) == only & set(rf), path
    assert set(pf) <= set(rf), (path, set(pf) - set(rf))
    for k in pf:
        _assert_same(rf[k], pf[k], f"{path}.{k}")


def test_registry_names_and_order():
    assert list(P.REGISTRY) == list(R.REGISTRY)
    with pytest.raises(KeyError, match="unknown arch"):
        P.get_config("gpt-2")


@pytest.mark.parametrize("arch", sorted(R.REGISTRY))
def test_config_field_by_field(arch):
    ref, port = R.get_config(arch), P.get_config(arch)
    _assert_same(ref, port)
    # the reference-only knobs stay at their defaults in every config
    for name in REFERENCE_ONLY["ModelConfig"]:
        assert getattr(ref, name) == _defaults(ref)[name]


@pytest.mark.parametrize("arch", sorted(R.REGISTRY))
def test_reduced_field_by_field(arch):
    _assert_same(R.reduced(R.get_config(arch)),
                 P.reduced(P.get_config(arch)))


@pytest.mark.parametrize("arch", sorted(R.REGISTRY))
def test_shapes_for(arch):
    assert P.shapes_for(P.get_config(arch)) == \
        R.shapes_for(R.get_config(arch))
    assert {k: tuple(_fields(v).values()) for k, v in P.SHAPES.items()} == \
        {k: tuple(_fields(v).values()) for k, v in R.SHAPES.items()}


def test_unserved_families_raise():
    """The hybrid and audio families serve through the one-shot API
    only: chunked prefill (the engine's path) refuses them with the
    reference's message; both train (a finite loss from
    ``api.loss_fn``)."""
    from repro_torch.data import synthetic as tsynthetic
    for arch in ("zamba2-1.2b", "whisper-tiny"):
        cfg = P.reduced(P.get_config(arch))
        with pytest.raises(NotImplementedError,
                           match="chunked prefill serves lm families"):
            tapi.prefill_chunk_fn(cfg)
        params = tapi.init_params(cfg, device="cpu", hold_bf16=False)
        batch = {k: torch.from_numpy(v) for k, v in
                 tsynthetic.make_batch(cfg, 16, 2, seed=1).items()}
        loss, _ = tapi.loss_fn(cfg)(params, batch)
        assert bool(torch.isfinite(loss))


def _served(arch):
    """(reference cfg, port cfg) as the serving CLI serves them: a vlm
    is served text-only as a dense model."""
    ref, port = R.reduced(R.get_config(arch)), P.reduced(P.get_config(arch))
    if ref.family == "vlm":
        ref = ref.with_(vlm=None, family="dense")
        port = port.with_(vlm=None, family="dense")
    return ref, port


def _prompt(n=29, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


@pytest.mark.parametrize("arch", ["stablelm-3b", "olmoe-1b-7b",
                                  "llava-next-mistral-7b"])
def test_served_family_matches_reference(arch):
    """Two prefill chunks, then a greedy decode rollout of ``STEPS``
    tokens, on both stacks from the reference's parameters and caches:
    prefill logits within ``LOGIT_ATOL``, decode logits within
    ``DECODE_ATOL``, tokens equal."""
    cfg, tcfg = _served(arch)
    params = common.init_params(api.schema(cfg), jax.random.key(0))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    kv = api.KVCache.build(cfg, max_context=64, block_size=16, max_slots=1)
    caches = paged.reset_slot(kv.init(1), jnp.int32(0),
                              jnp.arange(1, 5, dtype=jnp.int32))
    tcaches = bridge.caches_from_reference(jax.tree.map(np.asarray, caches),
                                           device="cpu")
    chunk = jax.jit(api.prefill_chunk_fn(cfg))
    decode = jax.jit(api.decode_fn(cfg))
    tchunk, tdecode = tapi.prefill_chunk_fn(tcfg), tapi.decode_fn(tcfg)
    prompt = _prompt()
    for pos0, c in ((0, 20), (20, 9)):
        toks = prompt[pos0:pos0 + c][None]
        lg, caches = chunk(params, jnp.asarray(toks), caches, jnp.int32(0),
                           jnp.int32(pos0))
        tlg = tchunk(tparams, torch.from_numpy(toks), tcaches, 0, pos0)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg),
                                   atol=LOGIT_ATOL, rtol=0)
    got, want = [], []
    for _ in range(STEPS):
        want.append(int(np.argmax(np.asarray(lg)[0])))
        got.append(int(tlg[0].argmax()))
        t = np.array([[want[-1]]], np.int32)
        lg, caches = decode(params, jnp.asarray(t), caches)
        tlg = tdecode(tparams, torch.from_numpy(t), tcaches)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg),
                                   atol=DECODE_ATOL[arch], rtol=0)
    assert got == want


def test_vlm_forward_with_patches():
    """``lm_forward`` of reduced llava with patch embeddings: the
    projected patches prefix the tokens (the vision projector and the
    tanh GELU), logits [B, P + L, V] within ``LOGIT_ATOL``."""
    cfg = R.reduced(R.get_config("llava-next-mistral-7b"))
    tcfg = P.reduced(P.get_config("llava-next-mistral-7b"))
    params = common.init_params(api.schema(cfg), jax.random.key(2))
    tparams = bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                           device="cpu")
    assert set(tparams["vision_proj"]) == {"w1", "w2"}
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (2, 11)).astype(np.int32)
    patches = rng.standard_normal((2, cfg.vlm.num_patches,
                                   cfg.vlm.vision_dim)).astype(np.float32)
    batch = {"tokens": jnp.asarray(tokens),
             "patch_embeds": jnp.asarray(patches)}
    fwd = jax.jit(lambda p, b: lm.lm_forward(p, b, cfg)).lower(
        params, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})
    want, _ = fwd(params, batch)
    got, _ = tlm.lm_forward(tparams, {"tokens": torch.from_numpy(tokens),
                                      "patch_embeds":
                                          torch.from_numpy(patches)}, tcfg)
    assert got.shape == (2, 8 + 11, 256)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=LOGIT_ATOL, rtol=0)
