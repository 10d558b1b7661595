"""The bf16 products (``repro_torch.kernels.invariant_gemm``, dispatched
by its ``product`` for ``models.common.dense``, ``models.moe._expert_matmul``
and flash attention's score and PV products): the plain twin against the
reference's ``repro.models.common.dense`` on the same seeded operands,
the CPU dispatch (the twin, no launch), the K split's plan (set by B, K
and N, never M; flash attention's planned for its heads, never the
sequences of a call), the wrapper's checks, and on the card the kernel:
every row bitwise the same at any M and batch place, a sequence's
attention bitwise the same alone and among 8, within K 2^-23 sum|x w| of
the twin, one launch per served call, none under autograd, and
``_Bf16BatchedProduct``'s backward against the plain one.

Tolerance against the reference: both sides form exact bf16 x bf16
products and sum K of them in f32 in their own order (XLA's dot against
torch's), then round once to bf16: the outputs differ by at most the one
bf16 step (2^-7 of |y|, plus a few f32 ulps of sum|x w|) such a
difference can cross.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common as rcommon  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import invariant_gemm as ig  # noqa: E402
from repro_torch.models import attention, common, moe  # noqa: E402

ROWS = (1, 8, 40, 240, 256)


def _case(m, k, n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    x = rng.standard_normal(lead + (m, k)).astype(np.float32)
    w = (rng.standard_normal(lead + (k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("m,k,n", [(8, 64, 64), (40, 96, 136), (5, 33, 7)])
def test_twin_matches_reference_dense(m, k, n):
    x, w = _case(m, k, n)
    want = np.asarray(rcommon.dense(jnp.asarray(x), jnp.asarray(w)),
                      np.float32)
    got = common.dense(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(x) @ np.abs(w)
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want)
                  + k * 2.0 ** -23 * scale)


def test_twin_is_the_widened_product():
    x, w = _case(16, 48, 24, seed=1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    want = torch.matmul(tx.to(torch.bfloat16).float(),
                        tw.to(torch.bfloat16).float())
    assert torch.equal(ig.invariant_gemm_plain(tx, tw), want)


def test_expert_products_match_reference():
    """The batched twin (``moe._expert_matmul`` on the CPU) against the
    reference's expert einsum, f32 products of bf16 operands."""
    x, w = _case(8, 32, 24, seed=2, batch=4)
    bf = jnp.bfloat16
    want = np.asarray(jnp.einsum("ecd,edf->ecf", jnp.asarray(x, bf),
                                 jnp.asarray(w, bf),
                                 preferred_element_type=jnp.float32))
    got = moe._expert_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    scale = np.einsum("ecd,edf->ecf", np.abs(x), np.abs(w))
    assert np.all(np.abs(got.numpy() - want) <= 32 * 2.0 ** -23 * scale)


def test_cpu_dispatch_is_the_twin():
    x, w = _case(8, 64, 32, seed=3)
    _build.reset_launches()
    y = common.dense(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(y, ig.invariant_gemm_plain(
        torch.from_numpy(x), torch.from_numpy(w)).to(torch.bfloat16))
    assert _build.launches["invariant_gemm"] == 0


def _first_form_plan(b, k, n):
    """The K split of the kernel's first form: 64-column tiles, K
    granules of 32, up to 32 parts."""
    tiles = b * -(-n // 64)
    kg = -(-k // 32)
    want = min(kg, 32, max(1, -(-132 // tiles)))
    cpg = -(-kg // want)
    return -(-kg // cpg), cpg


@pytest.mark.parametrize("b,k,n", [
    (1, 1024, 1024), (1, 1024, 5632), (1, 2816, 1024), (16, 64, 512),
    (16, 512, 64), (1, 5120, 576), (1, 16384, 5120), (1, 5120, 160),
    (160, 5120, 3072), (1, 384, 384), (1, 1536, 384), (1, 33, 7)])
def test_split_plan_is_set_by_b_k_n(b, k, n):
    """Every part holds at least one K granule, none is empty, the parts
    cover K, at most ``MAX_SPLITS``; and the plan is the kernel's first
    form's wherever that one had ``MAX_SPLITS`` parts or fewer (every
    product of qwen1.5-0.5b: its q/k/v/o, gate_up and down, its
    attention's score and PV at 16 heads), so the products keep their
    bits; past that (deepseek-v2's router: 32 parts) it is capped."""
    splits, cpg = ig.split_plan(b, k, n)
    kg = -(-k // ig.BK)
    assert 1 <= splits <= ig.MAX_SPLITS
    assert (splits - 1) * cpg < kg <= splits * cpg
    first = _first_form_plan(b, k, n)
    if first[0] <= ig.MAX_SPLITS:
        assert (splits, cpg) == first
    else:
        assert splits == ig.MAX_SPLITS
    assert "m" not in ig.split_plan.__code__.co_varnames


@pytest.mark.parametrize("b,k,n", [(1, 1024, 5632), (160, 1536, 5120)])
def test_route_is_set_by_m_and_keeps_the_plan(b, k, n, monkeypatch):
    """The skinny route up to ``SKINNY_ROWS`` rows, the wide one above;
    the choice reads M alone, and the K split the wrapper hands either
    route is ``split_plan(B, K, N)`` (the C entry point stood in for by a
    recorder of its arguments)."""
    assert "m" in ig.pick_route.__code__.co_varnames
    assert ig.pick_route.__code__.co_argcount == 1
    routes = {m: ig.pick_route(m) for m in (1, 8, 40, 64, 65, 240, 2048)}
    assert routes == {1: "skinny", 8: "skinny", 40: "skinny", 64: "skinny",
                      65: "wide", 240: "wide", 2048: "wide"}
    calls = []

    class Lib:
        def repro_invariant_gemm(self, *args):
            calls.append(args)
            return 0

    class Fake:
        """Stands in for a CUDA tensor: shapes, a data pointer, a device."""
        is_cuda = True
        device = torch.device("cpu")
        dtype = torch.bfloat16

        def __init__(self, shape):
            self.shape = torch.Size(shape)

        def dim(self):
            return len(self.shape)

        def __getitem__(self, _):
            return Fake((1,) + tuple(self.shape))

        def contiguous(self):
            return self

        def data_ptr(self):
            return 1 << 20

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(ig, "_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: Fake((1,)))
    for m in (1, 8, 40, 64, 65, 240, 2048):
        for force in (None, "skinny", "wide"):
            x = Fake((b, m, k))
            ig.invariant_gemm_cuda(x, Fake((b, k, n)), route=force)
            _x, _w, _y, bb, mm, nn, kk, splits, cps, wide, _a, _s = calls[-1]
            assert (bb, mm, nn, kk) == (b, m, n, k)
            assert (splits, cps) == ig.split_plan(b, k, n)
            assert wide == ((force or routes[m]) == "wide")


def _qkv(b, seed=6, lq=96, lk=300, hq=4, hkv=2, d=16, device="cpu"):
    """bf16 q / k / v whose sequence 0 is the same at every b."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((8, n, h, d), generator=g)[:b].to(device,
                                                             torch.bfloat16)
               for n, h in ((lq, hq), (lk, hkv), (lk, hkv)))
    return q, k, v


def test_attention_split_plan_ignores_the_sequences(monkeypatch):
    """Flash attention's served products plan their K split for the heads
    alone: the same plans at b = 1 and b = 8 (the kernel stood in for by
    a recorder of its plan that returns the twin)."""
    plans = []

    def recorder(x, w, *, plan_batch=None):
        plans[-1].append(ig.split_plan(
            x.shape[0] if plan_batch is None else plan_batch,
            x.shape[-1], w.shape[-1]))
        return ig.invariant_gemm_plain(x, w)

    monkeypatch.setattr(ig, "use_kernel", lambda *t: True)
    monkeypatch.setattr(ig, "invariant_gemm_cuda", recorder)
    outs = []
    for b in (1, 8):
        plans.append([])
        q, k, v = _qkv(b)
        with torch.no_grad():
            outs.append(attention.flash_attention(q, k, v, q_chunk=32,
                                                  kv_chunk=256))
    assert plans[0] and plans[0] == plans[1]
    assert torch.equal(outs[0][0], outs[1][0])


def test_wrapper_checks():
    x, w = _case(8, 64, 32)
    with pytest.raises(ValueError, match="CUDA"):
        ig.invariant_gemm_cuda(torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(w).to(torch.bfloat16))


def test_kernel_on_card_rows_do_not_depend_on_m():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    for b, k, n in ((None, 1024, 1024), (None, 2816, 1024), (None, 40, 37),
                    (4, 256, 192)):
        x, w = _case(max(ROWS), k, n, seed=4, batch=b)
        xd = torch.from_numpy(x).to(dev, torch.bfloat16)
        wd = torch.from_numpy(w).to(dev, torch.bfloat16)
        full = ig.invariant_gemm_cuda(xd, wd)
        for m in ROWS:
            assert torch.equal(ig.invariant_gemm_cuda(xd[..., :m, :], wd),
                               full[..., :m, :])
        assert torch.equal(ig.invariant_gemm_cuda(
            xd[..., 17:57, :].contiguous(), wd), full[..., 17:57, :])
        plain = ig.invariant_gemm_plain(xd, wd)
        scale = ig.invariant_gemm_plain(xd.abs(), wd.abs())
        assert bool(((full - plain).abs() <= k * 2.0 ** -23 * scale).all())
    with pytest.raises(ValueError, match="bf16"):
        ig.invariant_gemm_cuda(xd.float(), wd)
    # one launch per served call, none under autograd
    x2 = xd[0, :8]
    w2 = wd[0]
    _build.reset_launches()
    with torch.no_grad():
        common.dense(x2, w2)
        moe._expert_matmul(xd[:, :8], wd)
    assert _build.launches["invariant_gemm"] == 2
    wg = w2.float().requires_grad_(True)
    common.dense(x2, wg).float().sum().backward()
    assert _build.launches["invariant_gemm"] == 2 and wg.grad is not None


def test_kernel_on_card_routes_give_the_same_bits():
    """The skinny and the wide route, forced at the same M on either side
    of the boundary, and a row across the boundary (M = 64 and 65), give
    the same bits, on an aligned shape (TMA staging), unaligned ones (the
    threads' own loads; K = 1000 walks several chunks a part) and a
    batched one; the unaligned ones within K 2^-23 sum|x w| of the
    twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    for b, k, n in ((None, 1024, 1024), (None, 200, 37), (3, 192, 520),
                    (None, 1000, 300)):
        x, w = _case(300, k, n, seed=7, batch=b)
        xd = torch.from_numpy(x).to(dev, torch.bfloat16)
        wd = torch.from_numpy(w).to(dev, torch.bfloat16)
        if k % 8 or n % 8:
            plain = ig.invariant_gemm_plain(xd, wd)
            scale = ig.invariant_gemm_plain(xd.abs(), wd.abs())
            got = ig.invariant_gemm_cuda(xd, wd)
            assert bool(((got - plain).abs() <= k * 2.0 ** -23 * scale)
                        .all()), (b, k, n)
        edge = ig.invariant_gemm_cuda(xd[..., :ig.SKINNY_ROWS, :], wd)
        over = ig.invariant_gemm_cuda(xd[..., :ig.SKINNY_ROWS + 1, :], wd)
        assert torch.equal(over[..., :ig.SKINNY_ROWS, :], edge)
        for m in (8, 64, 65, 300):
            one, other = (ig.invariant_gemm_cuda(xd[..., :m, :], wd,
                                                 route=r)
                          for r in ("skinny", "wide"))
            assert torch.equal(one, other), (b, k, n, m)


def test_attention_on_card_sequence_bits_do_not_depend_on_batch():
    """A sequence's served attention (score and PV products on the
    kernel) is bitwise the same alone and among 8 sequences, at qwen1.5's
    head shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    outs = []
    _build.reset_launches()
    for b in (1, 8):
        q, k, v = _qkv(b, lq=300, lk=300, hq=16, hkv=16, d=64, device=dev)
        with torch.no_grad():
            outs.append(attention.flash_attention(q, k, v, q_chunk=256,
                                                  kv_chunk=512))
    assert _build.launches["invariant_gemm"] > 0
    assert torch.equal(outs[0][0], outs[1][0])


def test_oneshot_prefill_is_the_engines_chunks_on_card():
    """Served on the kernel, flash attention walks keys in blocks of
    ``kv_chunk`` whatever Lk is: a one-shot prefill of a prompt shorter
    than ``kv_chunk`` gives the last position's logits bitwise the
    engine's chunked prefill over the slot's pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import api, paged
    dev = torch.device("cuda")
    cfg = reduced(get_config("qwen1.5-0.5b")).with_(
        vocab_size=512, q_chunk=64, kv_chunk=256)
    params = api.init_params(cfg, device=dev, seed=0)
    prompt = torch.randint(0, 512, (1, 150), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3)
                           ).to(dev)
    with torch.no_grad():
        one, _ = api.prefill_fn(cfg, 256)(params, {"tokens": prompt})
        kv = api.KVCache.build(cfg, max_context=256, block_size=16,
                               max_slots=1)
        caches = kv.init(1, device=dev)
        paged.reset_slot(caches, 0, torch.arange(
            1, 1 + kv.layout.max_blocks, dtype=torch.int32, device=dev))
        for p0 in range(0, prompt.shape[1], 64):
            last = api.prefill_chunk_fn(cfg)(params, prompt[:, p0:p0 + 64],
                                             caches, 0, p0)
    assert torch.equal(one, last.reshape(one.shape))


def test_batched_product_backward_on_card():
    """``_Bf16BatchedProduct``'s gradients against the plain widened
    product's, each rounded to bf16 as the forward's operands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    x, w = _case(24, 128, 96, seed=5, batch=3)
    grads = []
    for card in (True, False):
        xd = torch.from_numpy(x).to(dev).requires_grad_(True)
        wd = torch.from_numpy(w).to(dev).requires_grad_(True)
        if card:
            y = moe._expert_matmul(xd, wd)
        else:
            y = ig.invariant_gemm_plain(xd, wd)
        (y * torch.linspace(-1, 1, y.numel(), device=dev).reshape(
            y.shape)).sum().backward()
        grads.append((xd.grad, wd.grad))
    for got, want in zip(grads[0], grads[1]):
        assert got.dtype == torch.float32
        assert float((got - want).norm() / want.norm()) < 1e-2
