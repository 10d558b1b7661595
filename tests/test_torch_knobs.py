"""The layout knobs the production dry run sets, in the port: the
reference's ``causal_packing`` (the port's flash attention walks only
the key blocks on or below the diagonal wherever the reference's
conditions hold, with no field to set) and ``remat_policy`` ("dots": a
recomputed layer keeps its products' outputs), against the port's own
baseline and the reference's knobs on the same inputs (numpy seeds; the
reference's parameters crossing through ``repro_torch.bridge``).

Tolerances, and why:
  * packed vs the full walk in the port (a ``q_offset`` given as a
    tensor 0 walks every block): bitwise, on the twin route and on the
    kernel route (its dispatch run on the CPU with the kernel's plain
    twin in its place). A block past the diagonal is all masked and adds
    exact zeros (p = 0, corr = exp(0) = 1).
  * the port's packed attention vs the reference's packed
    ``flash_attention`` (outputs of magnitude ~1): within 2^-9 of each
    element, at most 1 in 1000 elements apart. Both round f32 sums of
    the same products to bf16, but XLA sums them in its own order, so a
    rounding flips now and then; measured on these seeds at most 2.4e-4
    of the elements apart, by at most 9.8e-4 (5 bf16 steps of a small
    element), the same against the reference's unpacked walk.
  * losses vs the reference's jitted loss (``xla_allow_excess_precision``
    off, as ``test_torch_train.py`` compiles it): 5e-5 relative, that
    file's bound.
  * "dots" vs "nothing": loss and every gradient leaf bitwise
    (recompute is deterministic). What "dots" keeps is read from the
    products the backward recomputes: none of the forward's [M, K] x
    [K, N] products under "dots", every one under "nothing". (The
    outer ``saved_tensors_hooks`` cannot show it: a non-reentrant
    checkpoint packs only its inputs there, and the selective policy's
    cache sits inside it.)
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.models import api, common  # noqa: E402
from repro.models.attention import flash_attention as ref_flash  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core.kahan import tree_leaves  # noqa: E402
from repro_torch.kernels import invariant_gemm  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models.attention import flash_attention  # noqa: E402
from repro_torch.optim import accumulate as tacc  # noqa: E402

LOSS_RTOL = 5e-5
SEQ = 64                 # two query blocks of the reduced q_chunk 32
# (B, L, Hq, Hkv, D, q_chunk, kv_chunk)
SHAPES = [(2, 128, 4, 4, 16, 32, 32), (2, 96, 8, 2, 32, 32, 32),
          (1, 256, 4, 1, 64, 64, 64)]


def _qkv(b, l, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]


@pytest.mark.parametrize("shape", SHAPES)
def test_packed_flash_is_bitwise_the_full_walk(shape):
    b, l, hq, hkv, d, qc, kc = shape
    q, k, v = _qkv(b, l, hq, hkv, d)
    kw = dict(causal=True, q_chunk=qc, kv_chunk=kc)
    full = flash_attention(q, k, v, q_offset=torch.tensor(0), **kw)
    packed = flash_attention(q, k, v, **kw)
    assert torch.equal(full, packed)


def _kernel_route(monkeypatch) -> list:
    """Flash attention's served route on the CPU, the product's kernel
    replaced by its plain twin: the list the products' x shapes go to."""
    calls = []

    def twin(x, w, *, plan_batch=None, route=None):
        calls.append(tuple(x.shape))
        return invariant_gemm.invariant_gemm_plain(x, w)
    monkeypatch.setattr(invariant_gemm, "use_kernel", lambda *a: True)
    monkeypatch.setattr(invariant_gemm, "invariant_gemm_cuda", twin)
    return calls


@pytest.mark.parametrize("shape", SHAPES)
def test_packed_flash_is_bitwise_on_the_kernel_route(shape, monkeypatch):
    """The served route (the M-invariant product's blocks of kv_chunk
    keys), its kernel replaced by the plain twin on the CPU."""
    b, l, hq, hkv, d, qc, kc = shape
    calls = _kernel_route(monkeypatch)
    q, k, v = _qkv(b, l, hq, hkv, d, seed=1)
    kw = dict(causal=True, q_chunk=qc, kv_chunk=kc)
    with torch.no_grad():
        full = flash_attention(q, k, v, q_offset=torch.tensor(0), **kw)
        n_full = len(calls)
        packed = flash_attention(q, k, v, **kw)
    nq = l // qc
    assert n_full == 2 * nq * nq
    assert len(calls) - n_full == nq * (nq + 1)     # 2 products per pair
    assert torch.equal(full, packed)


def test_packing_keeps_the_references_conditions(monkeypatch):
    """No packing where the reference takes the full walk: an offset, a
    key length, the compensated accumulator, a walk that is not causal;
    2 query blocks by 2 key blocks, 2 products a block (kernel route)."""
    calls = _kernel_route(monkeypatch)
    q, k, v = _qkv(1, 64, 2, 2, 16, seed=2)
    base = dict(causal=True, q_chunk=32, kv_chunk=32)
    with torch.no_grad():
        for extra, blocks in ((dict(), 3), (dict(q_offset=torch.tensor(0)), 4),
                              (dict(kv_len=60), 4), (dict(kahan_acc=True), 4),
                              (dict(causal=False), 4)):
            calls.clear()
            flash_attention(q, k, v, **dict(base, **extra))
            assert len(calls) == 2 * blocks, extra


@pytest.mark.parametrize("shape", SHAPES)
def test_packed_flash_against_the_reference(shape):
    b, l, hq, hkv, d, qc, kc = shape
    q, k, v = _qkv(b, l, hq, hkv, d, seed=3)
    got = flash_attention(q, k, v, causal=True, q_chunk=qc,
                          kv_chunk=kc).float().numpy()
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    want = np.asarray(ref_flash(jq, jk, jv, causal=True, q_chunk=qc,
                                kv_chunk=kc, causal_packing=True),
                      np.float32)
    assert np.abs(got - want).max() <= 2.0 ** -9
    assert (got != want).mean() <= 1e-3


def _ref_loss(cfg, params, batch):
    fn = jax.jit(api.loss_fn(cfg))
    compiled = fn.lower(params, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return float(compiled(params, batch)[0])


def _port(params):
    return bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                        "cpu", hold_bf16=False)


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def qwen():
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(remat=True)
    tcfg = t_reduced(t_get_config("qwen1.5-0.5b")).with_(remat=True)
    params = common.init_params(api.schema(cfg), jax.random.key(0))
    batch = synthetic.make_batch(cfg, SEQ, 4, seed=3)
    return cfg, tcfg, params, batch


def test_packed_training_loss_against_the_reference(qwen):
    """The port's training loss (packed) against the reference's with
    ``causal_packing`` on and off."""
    cfg, tcfg, params, batch = qwen
    got, _ = tapi.loss_fn(tcfg)(_port(params), _tbatch(batch))
    for packing in (True, False):
        want = _ref_loss(cfg.with_(causal_packing=packing), params, batch)
        np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def _grads(tcfg, params, batch):
    (loss, _), grads = tacc.value_and_grad(tapi.loss_fn(tcfg),
                                           _port(params), _tbatch(batch))
    return loss, tree_leaves(grads)


def test_remat_dots_is_bitwise_nothing(qwen):
    _, tcfg, params, batch = qwen
    loss_n, g_n = _grads(tcfg, params, batch)
    loss_d, g_d = _grads(tcfg.with_(remat_policy="dots"), params, batch)
    assert torch.equal(loss_n, loss_d)
    assert len(g_n) == len(g_d) == 25
    assert all(torch.equal(a, b) for a, b in zip(g_n, g_d))


def test_remat_dots_loss_against_the_reference(qwen):
    cfg, tcfg, params, batch = qwen
    want = _ref_loss(cfg.with_(remat_policy="dots"), params, batch)
    got, _ = tapi.loss_fn(tcfg.with_(remat_policy="dots"))(_port(params),
                                                           _tbatch(batch))
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


class _Products(TorchDispatchMode):
    """Counts [M, K] x [K, N] products by phase."""

    def __init__(self):
        super().__init__()
        self.phase, self.counts = "forward", {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype):
            self.counts[self.phase] = self.counts.get(self.phase, 0) + 1
        return func(*args, **(kwargs or {}))


def _product_counts(tcfg, params, batch) -> dict:
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(_port(params))]
    tree = bridge.params_from_reference(
        jax.tree.map(np.asarray, params), "cpu", hold_bf16=False)
    from repro_torch.core.kahan import tree_unflatten
    tree = tree_unflatten(tree, leaves)
    with _Products() as mode:
        loss, _ = tapi.loss_fn(tcfg)(tree, _tbatch(batch))
        mode.phase = "backward"
        torch.autograd.grad(loss, leaves)
    return mode.counts


def test_remat_dots_keeps_the_products(qwen):
    """Under "dots" the backward recomputes none of the forward's
    products: it runs only its own two per product (dX, dW). Under
    "nothing" it recomputes each layer's products up to the last one
    whose output its backward reads (torch's recompute stops there: 5
    of a qwen1.5 layer's 6, all but the MLP's down projection)."""
    _, tcfg, params, batch = qwen
    nothing = _product_counts(tcfg, params, batch)
    dots = _product_counts(tcfg.with_(remat_policy="dots"), params, batch)
    assert nothing["forward"] == dots["forward"] == 6 * tcfg.num_layers + 1
    assert dots["backward"] == 2 * dots["forward"]
    assert nothing["backward"] - dots["backward"] == 5 * tcfg.num_layers


def test_remat_policy_must_be_known(qwen):
    _, tcfg, params, batch = qwen
    with pytest.raises(ValueError, match="remat_policy"):
        tapi.loss_fn(tcfg.with_(remat_policy="everything"))(
            _port(params), _tbatch(batch))


# ------------------------------------------------ per-query-block remat ----

def _loss_weighs(monkeypatch, nbytes: int):
    """The loss's bytes per logit for flash attention's rule (``attention
    .beside_loss``), the loss alone weighed (the gradients past the
    first layer taken as nothing): 0 checkpoints every walk of more than
    one query block, a huge one none."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "LOSS_BYTES_PER_LOGIT",
                        {True: nbytes, False: nbytes})
    monkeypatch.setattr(attention, "grads_after_first_layer",
                        lambda *a: 0)


ALWAYS, NEVER = 0, 1 << 40


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_query_block_checkpoint_keeps_the_gradients(qwen, policy,
                                                    monkeypatch):
    """SEQ 64 over q_chunk 32: two query blocks, each checkpointed inside
    the layer's own recompute. Loss and every gradient leaf bitwise the
    walk without the per-block checkpoint, under either policy."""
    _, tcfg, params, batch = qwen
    tcfg = tcfg.with_(remat_policy=policy)
    assert SEQ // tcfg.q_chunk == 2
    _loss_weighs(monkeypatch, ALWAYS)
    loss_c, g_c = _grads(tcfg, params, batch)
    _loss_weighs(monkeypatch, NEVER)
    loss_p, g_p = _grads(tcfg, params, batch)
    assert torch.equal(loss_c, loss_p)
    assert len(g_c) == len(g_p) == 25
    assert all(torch.equal(a, b) for a, b in zip(g_c, g_p))


def _peak_of_step(tcfg, params, batch) -> float:
    """``StepCounter``'s peak live set over the loss and its gradients."""
    from repro_torch.ecm import step_cost
    with step_cost.StepCounter() as counter:
        _grads(tcfg, params, batch)
    return counter.cost.peak_bytes


@pytest.fixture(scope="module")
def qwen_long():
    """A reduced qwen1.5 training step at 8 query blocks (seq 256,
    q_chunk 32, batch 4): a layer's scores, 4 heads x 4.5 key blocks of
    32 x 12 bytes = 6912 bytes a token for the whole walk, outweigh the
    loss's 256 logits x 20 bytes = 5120."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    tcfg = t_reduced(t_get_config("qwen1.5-0.5b")).with_(remat=True)
    params = common.init_params(api.schema(cfg), jax.random.key(0))
    return tcfg, params, synthetic.make_batch(cfg, 256, 4, seed=3)


@pytest.fixture(scope="module")
def qwen_wide_vocab():
    """The ``qwen`` step (SEQ 64, two query blocks) with a vocabulary of
    512: its loss's 512 logits x 20 bytes = 10240 bytes a token outweigh
    a layer's scores and its own backward transient together (2304 +
    3840 bytes a token)."""
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(remat=True,
                                                    vocab_size=512)
    tcfg = t_reduced(t_get_config("qwen1.5-0.5b")).with_(remat=True,
                                                        vocab_size=512)
    params = common.init_params(api.schema(cfg), jax.random.key(0))
    return tcfg, params, synthetic.make_batch(cfg, SEQ, 4, seed=3)


def test_query_block_checkpoint_lowers_the_peak(qwen_long, monkeypatch):
    """Where the scores outweigh the loss, the rule checkpoints each
    query block (``test_query_block_checkpoint_only_where_scores_
    outweigh_the_loss``), and the peak of the step's live set is
    strictly lower than without: the layer's recompute no longer keeps
    every block's scores for its backward."""
    tcfg, params, batch = qwen_long
    by_rule = _peak_of_step(tcfg, params, batch)
    _loss_weighs(monkeypatch, NEVER)
    without = _peak_of_step(tcfg, params, batch)
    assert by_rule < without, (by_rule, without)


class _Bmms(TorchDispatchMode):
    """Counts batched products (the attention walk's scores and PV)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._overloadpacket in (torch.ops.aten.bmm,
                                    torch.ops.aten.baddbmm):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _bmm_count(tcfg, params, batch) -> int:
    with _Bmms() as mode:
        _grads(tcfg, params, batch)
    return mode.n


def test_one_query_block_runs_the_same_ops(qwen, monkeypatch):
    """At one query block (q_chunk 64 over SEQ 64) the walk is as
    before: the same count of block products, forward and backward, with
    the per-block checkpoint as without; at two it recomputes each
    block's in backward, so it runs more."""
    _, tcfg, params, batch = qwen
    one = tcfg.with_(q_chunk=SEQ, kv_chunk=SEQ)
    _loss_weighs(monkeypatch, ALWAYS)
    n_one, n_two = _bmm_count(one, params, batch), _bmm_count(tcfg, params,
                                                              batch)
    _loss_weighs(monkeypatch, NEVER)
    assert _bmm_count(one, params, batch) == n_one
    assert _bmm_count(tcfg, params, batch) < n_two


def test_query_block_checkpoint_only_where_scores_outweigh_the_loss(
        qwen, qwen_wide_vocab, qwen_long, monkeypatch):
    """The rule as ``api.loss_fn`` sets it, the scores weighed with the
    layer's own backward transient (``attention.beside_layer``: 36
    bytes a d element, 12 a hidden one, 36 x 64 + 12 x 128 = 3840 bytes
    a token here): at SEQ 64 (two query blocks, 4 x 1.5 x 32 x 12 = 2304
    bytes of scores a token) each block is checkpointed against the
    loss's 5120 (where the whole walk sets a higher peak of the step's
    live set than the checkpointed one) and the walk stays whole against
    a 512-token vocabulary's 10240, the products those of the walk
    without the checkpoint; at seq 256 (6912 bytes) each block is
    checkpointed, the products those of the walk with it."""
    _, tcfg, params, batch = qwen
    steps = [(tcfg, params, batch), qwen_wide_vocab, qwen_long]
    by_rule = [_bmm_count(*s) for s in steps]
    _loss_weighs(monkeypatch, NEVER)
    never = [_bmm_count(*s) for s in steps]
    whole_peak = _peak_of_step(*steps[0])
    _loss_weighs(monkeypatch, ALWAYS)
    always = [_bmm_count(*s) for s in steps]
    assert _peak_of_step(*steps[0]) < whole_peak
    assert by_rule == [always[0], never[1], always[2]], (by_rule, never,
                                                         always)
    assert all(n < a for n, a in zip(never, always))


def _trainer_step(tcfg) -> tuple:
    """(``StepCounter``'s peak live set, batched products) of one
    ``Trainer`` step of ``tcfg`` (SEQ 64, batch 2, AdamW with its Kahan
    carry) after a first step: the loss, its gradients and the
    optimizer's update."""
    from repro_torch.ecm import step_cost
    from repro_torch.train.loop import Trainer
    trainer = Trainer(tcfg, seq_len=SEQ, global_batch=2, device="cpu",
                      seed=0)
    trainer.init_state()
    trainer.run(1, log_every=0)
    with step_cost.StepCounter() as counter, _Bmms() as mode:
        trainer.run(1, log_every=0)
    return counter.cost.peak_bytes, mode.n


def test_query_block_walk_whole_where_the_gradients_set_the_peak(
        monkeypatch):
    """A reduced qwen1.5 trainer step at SEQ 64 (two query blocks) of
    batch 2 with d 256 and d_ff 2048: a layer's scores and transient,
    2304 + 36 x 256 + 12 x 2048 = 36 192 bytes a token (4.6 MB), outweigh
    the loss's 5120 (0.66 MB), but the gradients the step makes after its
    first layer's walk (that layer's and the embedding's, 6.6 MB f32:
    ``attention.grads_after_first_layer``) outweigh them both. The rule
    keeps the walk whole, and checkpointing each query block would lower
    no peak of the step's live set: the step peaks in the optimizer's
    update, every gradient live. Weighed against the loss alone, the
    rule would checkpoint it."""
    from repro_torch.models import attention
    tcfg = t_reduced(t_get_config("qwen1.5-0.5b")).with_(
        remat=True, d_model=256, d_ff=2048)
    peak, by_rule = _trainer_step(tcfg)
    monkeypatch.setattr(attention, "grads_after_first_layer", lambda *a: 0)
    _, loss_alone = _trainer_step(tcfg)
    _loss_weighs(monkeypatch, NEVER)
    _, never = _trainer_step(tcfg)
    _loss_weighs(monkeypatch, ALWAYS)
    always_peak, always = _trainer_step(tcfg)
    assert by_rule == never < always == loss_alone, (by_rule, never,
                                                     always, loss_alone)
    assert always_peak == peak, (always_peak, peak)


def test_query_block_checkpoint_waits_for_a_loss(qwen):
    """Outside a training loss (``attention.beside_loss`` never entered)
    a walk under autograd stays whole: the products of the walk without
    the checkpoint."""
    from repro_torch.models import attention
    _, tcfg, params, batch = qwen
    q, k, v = (t.requires_grad_(True) for t in _qkv(2, SEQ, 4, 4, 16))
    kw = dict(causal=True, q_chunk=32, kv_chunk=32)

    def count(nbytes):
        with _Bmms() as mode, attention.beside_loss(nbytes):
            flash_attention(q, k, v, **kw).float().sum().backward()
        return mode.n
    assert count(None) == count(1 << 40) < count(0)
