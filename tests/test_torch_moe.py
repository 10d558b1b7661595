"""Port parity of ``repro_torch.models.moe.moe_forward`` against the
reference ``repro.models.moe.moe_forward`` on the reference's own
parameters (crossing through numpy) and the same inputs.

Routing is integer work on identical router logits, so the capacity
drops and ``moe_drop_fraction`` agree EXACTLY. The outputs agree to a
bf16 step: both sides multiply bf16-rounded operands with f32 sums but
in another order (torch vs XLA GEMMs), and a near-tie can round to
either neighbouring bf16 value (relative 2^-7 on bf16 outputs; measured
max |port - reference| below). Inside the port the output is bitwise
run-to-run (the fold back to tokens has a fixed order, no atomics).
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common as rcommon  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import mlp, moe  # noqa: E402

D = 64


def _params(cfg, d, seed=0):
    rcfg = rmoe.MoEConfig(**cfg._asdict())
    p = rcommon.init_params(rmoe.moe_schema(d, rcfg), jax.random.key(seed))
    tp = jax.tree.map(
        lambda a: bridge.from_numpy(np.asarray(a), device="cpu"), p)
    return rcfg, p, tp


def _x(shape, dtype, seed=1):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                    .astype(np.float32)).astype(dtype)
    return x, bridge.from_numpy(np.asarray(x), device="cpu")


def _run_both(cfg, d, shape, dtype):
    rcfg, p, tp = _params(cfg, d)
    x, tx = _x(shape, dtype)
    y, aux = jax.jit(lambda p, x: rmoe.moe_forward(p, x, rcfg))(p, x)
    ty, taux = moe.moe_forward(tp, tx, cfg)
    return (np.asarray(y.astype(jnp.float32)), {k: float(v) for k, v in
                                                aux.items()},
            ty.float().numpy(), {k: float(v) for k, v in taux.items()}, ty)


# measured max |port - reference| of y (max |y| 43.3): 7.8e-3 with bf16
# inputs (one bf16 step of an element near 1), 3.8e-6 with f32 inputs
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_moe_forward_matches_reference(dtype):
    """The reduced deepseek-v2 MoE (8 routed experts top-2, 2 shared)."""
    cfg = moe.MoEConfig(num_experts=8, top_k=2, d_ff=32, num_shared=2)
    y, aux, ty, taux, traw = _run_both(cfg, D, (2, 16, D), dtype)
    assert traw.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                          else torch.float32)
    np.testing.assert_allclose(ty, y, rtol=2.0 ** -7, atol=1e-6)
    assert taux["moe_drop_fraction"] == aux["moe_drop_fraction"]
    for k in ("moe_load_balance", "moe_z_loss"):
        np.testing.assert_allclose(taux[k], aux[k], rtol=1e-6)


def test_capacity_drops_match_reference_exactly():
    """tests/test_models_layers.py's drop case: 64 tokens, 4 experts,
    top-1, capacity factor 0.5 -> capacity 8, so most tokens drop; the
    stable sort keeps the earliest 8 per expert on both sides."""
    cfg = moe.MoEConfig(num_experts=4, top_k=1, d_ff=8, capacity_factor=0.5)
    y, aux, ty, taux, _ = _run_both(cfg, 8, (1, 64, 8), jnp.float32)
    assert moe.capacity(64, cfg) == rmoe.capacity(64, rmoe.MoEConfig(
        **cfg._asdict())) == 8
    assert aux["moe_drop_fraction"] >= 0.5      # 32 slots, 64 tokens
    assert taux["moe_drop_fraction"] == aux["moe_drop_fraction"]
    np.testing.assert_allclose(ty, y, rtol=2.0 ** -7, atol=1e-6)
    dropped = np.all(y == 0.0, axis=-1)           # rows with no expert
    np.testing.assert_array_equal(np.all(ty == 0.0, axis=-1), dropped)


def test_one_expert_equals_dense_mlp():
    """E=1, top-1 with bf16 activations: every token routes with gate 1,
    so the MoE is the MLP on the same weights, to f32 summation order
    (bmm vs matmul) before the same bf16 roundings."""
    cfg = moe.MoEConfig(num_experts=1, top_k=1, d_ff=16, capacity_factor=1.0)
    _, _, tp = _params(cfg, 8)
    _, tx = _x((1, 8, 8), jnp.bfloat16)
    y, aux = moe.moe_forward(tp, tx, cfg)
    want = mlp.mlp_forward({"w_gate_up": tp["w_gate_up"][0],
                            "w_down": tp["w_down"][0]}, tx)
    np.testing.assert_allclose(y.float().numpy(), want.float().numpy(),
                               rtol=2.0 ** -7, atol=1e-6)
    assert float(aux["moe_drop_fraction"]) == 0.0


def test_output_is_run_to_run_identical_and_chunking_is_exact(monkeypatch):
    cfg = moe.MoEConfig(num_experts=8, top_k=2, d_ff=32, num_shared=2)
    _, _, tp = _params(cfg, D)
    _, tx = _x((3, 8, D), jnp.bfloat16, seed=4)
    y1, a1 = moe.moe_forward(tp, tx, cfg)
    y2, a2 = moe.moe_forward(tp, tx, cfg)
    assert torch.equal(y1, y2) and a1.keys() == a2.keys()
    # the full-width layer widens its experts' weights a chunk at a time;
    # chunks of one expert give the same bits
    monkeypatch.setattr(moe, "_CHUNK_ELEMS", 1)
    y3, _ = moe.moe_forward(tp, tx, cfg)
    assert torch.equal(y1, y3)


def test_top_k_breaks_ties_like_the_reference():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 2)
    got_v, got_i = moe._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
