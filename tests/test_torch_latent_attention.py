"""Port parity: the latent (MLA) form of the paged-attention superkernel.

The plain twin ``paged_latent_attention_plain`` against the reference's
``ops.paged_attention(..., q_rope=..., interpret=True)`` (its
``paged_latent_attention_pallas``) on the same numpy inputs, over the
grid of tests/test_superkernel.py's MLA case: pool dtype {bf16, int8,
fp8} x width W in {1, K_DRAFT + 1}, permuted tables, ragged tails.

Tolerances: both sides return f32 context latents computed with the same
operations in another summation order (torch vs XLA dots of C + R terms
and p.v sums of a block), so they agree to 1e-5 (rtol and atol; the
largest measured gap on these inputs is 2.4e-7). Against the
dequantize-first oracle (opposite evaluation order: dequantize, then an
ordinary softmax) the reference's own 2e-4 holds. Inside the port,
table-permutation and width invariance are bitwise.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.models import paged as rpaged  # noqa: E402
from repro.quant import core as rq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.quant import core as tq  # noqa: E402

K_DRAFT = 4
DTYPES = ("bf16", "int8", "fp8")
B, H, C, R, BS, MB = 2, 3, 16, 8, 8, 3
SCALE = (16 + 8) ** -0.5            # (nope + rope)^-0.5 of a small MLA


def _case(fmt_name, w, seed=11, rope_dtype=jnp.bfloat16):
    """Reference-built latent pools (numpy, blocks permuted) + inputs."""
    rng = np.random.default_rng(seed)
    layout = rpaged.PagedLayout(BS, MB)
    rows_c = jnp.asarray(rng.standard_normal((B, MB * BS, C))
                         .astype(np.float32))
    rows_r = jnp.asarray(rng.standard_normal((B, MB * BS, R))
                         .astype(np.float32))
    fmt = rq.get_format(fmt_name)
    if fmt is None:
        pools = [rpaged.pool_from_rows(x.astype(jnp.bfloat16), layout)
                 for x in (rows_c, rows_r)] + [None, None]
    else:
        (qc, sc), (qr, sr) = (rq.quantize_lastdim(x, fmt)
                              for x in (rows_c, rows_r))
        pools = [rpaged.pool_from_rows(a, layout) for a in (qc, qr, sc, sr)]
    perm = np.concatenate([[0], 1 + rng.permutation(B * MB)]).astype(np.int32)
    inv = np.argsort(perm)
    pools = [None if p is None else np.asarray(p)[inv] for p in pools]
    table = perm[np.asarray(rpaged.identity_table(B, layout))]
    lens = np.array([w + 2, 2 * BS + 3], np.int32)
    q_lat = rng.standard_normal((B, w, H, C)).astype(np.float32)
    q_rope = np.asarray(jnp.asarray(rng.standard_normal((B, w, H, R))
                                    .astype(np.float32)).astype(rope_dtype))
    return dict(q_lat=q_lat, q_rope=q_rope, ck=pools[0], kr=pools[1],
                cs=pools[2], rs=pools[3], table=table, lens=lens,
                offs=lens - w)


def _ref(c):
    j = {k: None if v is None else jnp.asarray(v) for k, v in c.items()}
    return np.asarray(rops.paged_attention(
        j["q_lat"], j["ck"], None, j["table"], j["lens"], q_offsets=j["offs"],
        q_rope=j["q_rope"], rope_pool=j["kr"], kscale=j["cs"],
        rope_scale=j["rs"], scale=SCALE, interpret=True))


def _t(c):
    return {k: None if v is None else bridge.from_numpy(v, device="cpu")
            for k, v in c.items()}


def _port(t, lens=None, offs=None, w_slice=None):
    ql, qr = t["q_lat"], t["q_rope"]
    if w_slice is not None:
        ql, qr = ql[:, w_slice], qr[:, w_slice]
    return tpa.paged_latent_attention_plain(
        ql, qr, t["ck"], t["kr"], t["table"],
        t["lens"] if lens is None else lens,
        t["offs"] if offs is None else offs,
        ck_scale=t["cs"], kr_scale=t["rs"], scale=SCALE)


def _oracle(t):
    """Dequantize first, then an ordinary masked softmax (torch, f64)."""
    def rows(pool, scale):
        x = tq.cast_f32(pool[t["table"].long()].reshape(B, MB * BS, -1))
        if scale is not None:
            x = x * scale[t["table"].long()].reshape(B, MB * BS)[..., None]
        return x.double()
    ck, kr = rows(t["ck"], t["cs"]), rows(t["kr"], t["rs"])
    s = (torch.einsum("bwhc,bsc->bwhs", t["q_lat"].double(), ck)
         + torch.einsum("bwhr,bsr->bwhs", t["q_rope"].double(), kr)) * SCALE
    w = t["q_lat"].shape[1]
    lim = t["offs"].long()[:, None] + torch.arange(w)[None, :]
    mask = torch.arange(MB * BS)[None, None, None, :] <= lim[:, :, None, None]
    s = torch.where(mask, s, -torch.inf)
    return torch.einsum("bwhs,bsc->bwhc", torch.softmax(s, -1), ck)


@pytest.mark.parametrize("fmt_name", DTYPES)
@pytest.mark.parametrize("w", (1, K_DRAFT + 1))
def test_plain_twin_matches_reference_latent_kernel(fmt_name, w):
    c = _case(fmt_name, w)
    t = _t(c)
    got = _port(t)
    assert got.dtype == torch.float32 and got.shape == (B, w, H, C)
    np.testing.assert_allclose(got.numpy(), _ref(c), rtol=1e-5, atol=1e-5)
    # (b) width invariance, bitwise: row j == the width-1 call at offs + j
    for j in range(w):
        narrow = _port(t, lens=t["offs"] + j + 1, offs=t["offs"] + j,
                       w_slice=slice(j, j + 1))
        assert torch.equal(narrow[:, 0], got[:, j]), j
    # (c) the dequantize-first oracle
    np.testing.assert_allclose(got.numpy(), _oracle(t).numpy(), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("fmt_name", DTYPES)
def test_table_permutation_invariance_bitwise(fmt_name):
    t = _t(_case(fmt_name, K_DRAFT + 1, seed=5))
    got = _port(t)
    perm = torch.cat([torch.zeros(1, dtype=torch.int64),
                      1 + torch.randperm(B * MB, generator=torch.Generator()
                                         .manual_seed(3))])
    inv = torch.argsort(perm)
    tp = dict(t)
    for k in ("ck", "kr", "cs", "rs"):
        if t[k] is not None:
            tp[k] = t[k][inv]
    tp["table"] = perm[t["table"].long()].to(torch.int32)
    assert torch.equal(_port(tp), got)


def test_f32_rope_queries_and_dispatch():
    """f32 q_rope (the reference grid's own inputs) agree too;
    ``ops.paged_attention`` with ``q_rope`` dispatches CPU tensors to the
    latent twin (q_offsets default lens - W) and launches nothing."""
    c = _case("int8", 2, seed=2, rope_dtype=jnp.float32)
    t = _t(c)
    np.testing.assert_allclose(_port(t).numpy(), _ref(c), rtol=1e-5,
                               atol=1e-5)
    before = dict(ops.launches)
    out = ops.paged_attention(t["q_lat"], t["ck"], None, t["table"],
                              t["lens"], q_rope=t["q_rope"],
                              rope_pool=t["kr"], kscale=t["cs"],
                              rope_scale=t["rs"], scale=SCALE)
    assert torch.equal(out, _port(t)) and ops.launches == before
    with pytest.raises(ValueError):          # MLA needs the explicit scale
        ops.paged_attention(t["q_lat"], t["ck"], None, t["table"], t["lens"],
                            q_rope=t["q_rope"], rope_pool=t["kr"],
                            kscale=t["cs"], rope_scale=t["rs"])


def test_bound_counts():
    """The bound helpers count what the data needs: live latent blocks
    once (shared by every row) and each row's visible keys."""
    t = _t(_case("bf16", K_DRAFT + 1))
    w = K_DRAFT + 1
    keys = sum(int(o) + 1 + j for o in t["offs"] for j in range(w))
    assert tpa.latent_flops(t["q_lat"], t["q_rope"], t["offs"]) == \
        keys * H * (2 * (C + R) + 2 * C)
    live = sum(-(-int(n) // BS) for n in t["lens"])
    q_bytes = t["q_lat"].numel() * 4 + t["q_rope"].numel() * 2
    want = (q_bytes + t["q_lat"].numel() * 4 + live * BS * (C + R) * 2
            + t["table"].numel() * 4 + 2 * B * 4)
    assert tpa.latent_bytes_moved(t["q_lat"], t["q_rope"], t["ck"], t["kr"],
                                  t["table"], t["lens"]) == want


@pytest.mark.parametrize("fmt_name", DTYPES)
def test_cuda_kernel_matches_plain(fmt_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    t = {k: None if v is None else v.cuda()
         for k, v in _t(_case(fmt_name, K_DRAFT + 1, seed=13)).items()}
    args = (t["q_lat"], t["q_rope"], t["ck"], t["kr"], t["table"], t["lens"],
            t["offs"])
    kw = dict(ck_scale=t["cs"], kr_scale=t["rs"], scale=SCALE)
    before = ops.launches["paged_latent_attention"]
    got = tpa.paged_latent_attention_cuda(*args, **kw)
    assert ops.launches["paged_latent_attention"] == before + 1
    want = tpa.paged_latent_attention_plain(*args, **kw)
    # f32 outputs, summation order only (sequential FMA chains vs torch)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for j in range(K_DRAFT + 1):
        narrow = tpa.paged_latent_attention_cuda(
            t["q_lat"][:, j:j + 1].contiguous(),
            t["q_rope"][:, j:j + 1].contiguous(), t["ck"], t["kr"],
            t["table"], (t["offs"] + j + 1).contiguous(),
            (t["offs"] + j).contiguous(), **kw)
        assert torch.equal(narrow[:, 0], got[:, j])
