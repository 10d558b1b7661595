"""Port parity: the paged-attention superkernel's plain twin against
``paged_attention_pallas(..., interpret=True)``, over the reference's own
grid (tests/test_superkernel.py): width W in {1, 4, 5} x pool dtype
{bf16, int8, fp8} x permuted tables x ragged tails, grouped heads.

Tolerance: for bf16 queries both sides round one f32 result to bf16; the
f32 results differ only in the summation order of the q.k and p.v
products (torch vs XLA), so outputs agree to two bf16 ulps (relative
2^-7: a near-tie can round one way on each side, and the ulp is relative
to the binade, not the value). For f32 queries the same order difference
is held at 1e-5.
Inside the port, table-permutation and width invariance are bitwise.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import paged_attention as rpa  # noqa: E402
from repro.models import paged as rpaged  # noqa: E402
from repro.quant import core as rq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

WIDTHS = (1, 4, 5)
DTYPES = ("bf16", "int8", "fp8")
B, HQ, HKV, D, BS, MB = 3, 4, 2, 16, 8, 4


def _case(fmt_name, w, q_dtype=np.float32, seed=7):
    """Reference-built pools (as numpy) + inputs for a width-w call."""
    rng = np.random.default_rng(seed)
    layout = rpaged.PagedLayout(BS, MB)
    rows = [jnp.asarray(rng.standard_normal((B, MB * BS, HKV, D))
                        .astype(np.float32)) for _ in range(2)]
    fmt = rq.get_format(fmt_name)
    if fmt is None:
        pools = [rpaged.pool_from_rows(r.astype(jnp.bfloat16), layout)
                 for r in rows] + [None, None]
    else:
        (qk, sk), (qv, sv) = (rq.quantize_lastdim(r, fmt) for r in rows)
        pools = [rpaged.pool_from_rows(a, layout) for a in (qk, qv, sk, sv)]
    # scramble pool block order (null block 0 stays) and remap the table
    perm = np.concatenate([[0], 1 + rng.permutation(B * MB)]).astype(np.int32)
    inv = np.argsort(perm)
    pools = [None if p is None else np.asarray(p)[inv] for p in pools]
    table = perm[np.asarray(rpaged.identity_table(B, layout))]
    lens = np.array([w + 4, MB * BS, 2 * BS + 1], np.int32)
    q = jnp.asarray(rng.standard_normal((B, w, HQ, D)).astype(np.float32)
                    ).astype(q_dtype)
    return dict(q=np.asarray(q), kpool=pools[0], vpool=pools[1],
                kscale=pools[2], vscale=pools[3], table=table, lens=lens,
                offs=lens - w)


def _ref(c):
    return np.asarray(rpa.paged_attention_pallas(
        jnp.asarray(c["q"]), jnp.asarray(c["kpool"]), jnp.asarray(c["vpool"]),
        jnp.asarray(c["table"]), jnp.asarray(c["lens"]),
        jnp.asarray(c["offs"]),
        kscale=None if c["kscale"] is None else jnp.asarray(c["kscale"]),
        vscale=None if c["vscale"] is None else jnp.asarray(c["vscale"]),
        interpret=True).astype(jnp.float32))


def _t(c):
    return {k: None if v is None else bridge.from_numpy(v, device="cpu")
            for k, v in c.items()}


def _port(t, lens=None, offs=None, q=None):
    return tpa.paged_attention_plain(
        t["q"] if q is None else q, t["kpool"], t["vpool"], t["table"],
        t["lens"] if lens is None else lens,
        t["offs"] if offs is None else offs,
        kscale=t["kscale"], vscale=t["vscale"])


@pytest.mark.parametrize("fmt_name", DTYPES)
@pytest.mark.parametrize("w", WIDTHS)
def test_plain_twin_matches_reference_grid(fmt_name, w):
    c = _case(fmt_name, w, q_dtype=jnp.bfloat16)
    t = _t(c)
    got = _port(t)
    assert got.dtype == torch.bfloat16 and got.shape == (B, w, HQ, D)
    want = _ref(c)
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=2.0 ** -7, atol=1e-6)
    # bitwise width invariance inside the port: row j == width-1 at offs+j
    for j in range(w):
        narrow = _port(t, lens=t["offs"] + j + 1, offs=t["offs"] + j,
                       q=t["q"][:, j:j + 1])
        assert torch.equal(narrow[:, 0], got[:, j]), j


@pytest.mark.parametrize("fmt_name", DTYPES)
def test_plain_twin_f32_queries(fmt_name):
    c = _case(fmt_name, 4, q_dtype=np.float32, seed=3)
    got = _port(_t(c))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _ref(c), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt_name", DTYPES)
def test_table_permutation_invariance_bitwise(fmt_name):
    c = _case(fmt_name, 5, q_dtype=jnp.bfloat16, seed=11)
    t = _t(c)
    got = _port(t)
    perm = torch.cat([torch.zeros(1, dtype=torch.int64),
                      1 + torch.randperm(B * MB,
                                         generator=torch.Generator()
                                         .manual_seed(5))])
    inv = torch.argsort(perm)
    tp = dict(t)
    for k in ("kpool", "vpool", "kscale", "vscale"):
        if t[k] is not None:
            tp[k] = t[k][inv]
    tp["table"] = perm[t["table"].long()].to(torch.int32)
    assert torch.equal(_port(tp), got)


def test_idle_slot_and_dispatch():
    """An idle slot (all-null table, length drifted past the table) is
    bounded by the table width; ``ops.paged_attention`` defaults
    q_offsets to lens - W and dispatches CPU tensors to the twin."""
    c = _case("bf16", 1, q_dtype=jnp.bfloat16, seed=2)
    t = _t(c)
    t["table"][2] = 0
    t["lens"][2] = MB * BS + 9
    out = ops.paged_attention(t["q"], t["kpool"], t["vpool"], t["table"],
                              t["lens"])
    assert torch.isfinite(out.float()).all()
    before = dict(ops.launches)
    ref = _port(t, offs=t["lens"] - 1)
    assert torch.equal(out, ref) and ops.launches == before


@pytest.mark.parametrize("fmt_name", DTYPES)
def test_cuda_kernel_matches_plain(fmt_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    c = _case(fmt_name, 5, q_dtype=jnp.bfloat16, seed=13)
    t = {k: None if v is None else v.cuda() for k, v in _t(c).items()}
    args = (t["q"], t["kpool"], t["vpool"], t["table"], t["lens"], t["offs"])
    kw = dict(kscale=t["kscale"], vscale=t["vscale"])
    before = ops.launches["paged_attention"]
    got = tpa.paged_attention_cuda(*args, **kw)
    assert ops.launches["paged_attention"] == before + 1
    want = tpa.paged_attention_plain(*args, **kw)
    # one bf16 rounding of f32 results that differ in summation order
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-6)
    for j in range(5):
        narrow = tpa.paged_attention_cuda(
            t["q"][:, j:j + 1].contiguous(), t["kpool"], t["vpool"],
            t["table"], (t["offs"] + j + 1).contiguous(),
            (t["offs"] + j).contiguous(), **kw)
        assert torch.equal(narrow[:, 0], got[:, j])


def test_jax_is_cpu():
    assert jax.default_backend() == "cpu"
