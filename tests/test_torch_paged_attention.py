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
The CUDA kernel splits each table into fixed partitions of
``SLOTS_PER_PARTITION`` slots and merges them in index order; on the card
it is held to the twin at two bf16 ulps, with width, batch and
table-width invariance bitwise.
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


@pytest.mark.parametrize("mb,bs,parts", [(1, 16, 1), (4, 16, 1),
                                          (5, 16, 2), (30, 16, 8),
                                          (64, 16, 16), (64, 8, 16),
                                          (65, 4, 17)])
def test_partitions_and_scratch(mb, bs, parts):
    """Partition p owns table slots [4p, 4p + 4) whatever the block size
    (4 * bs tokens), so the count depends on the table width alone; the
    scratch holds (m, l_sum, l_carry) per row and (acc_sum, acc_carry)
    per output element for every (sequence, kv head, partition)."""
    assert tpa.SLOTS_PER_PARTITION == 4
    assert tpa.partitions(mb) == parts
    b, hkv, rows, dv = 3, 2, 10, 16
    assert tpa.scratch_floats(b, hkv, rows, dv, mb) == \
        b * hkv * parts * rows * (3 + 2 * dv)


def test_cuda_wrapper_refuses_cpu_tensors():
    t = _t(_case("bf16", 1, q_dtype=jnp.bfloat16))
    before = dict(ops.launches)
    with pytest.raises(ValueError):
        tpa.paged_attention_cuda(t["q"], t["kpool"], t["vpool"], t["table"],
                                 t["lens"], t["offs"])
    assert ops.launches == before


def _split_case(fmt_name, w, mb=10, bs=8, hkv=2, hq=4, d=16, seed=5):
    """Card inputs whose tables span several partitions (4 slots of 8
    tokens): lengths on the partition edges (31, 32, 33, 64), a one-token
    context and a table width (10) that is no multiple of 4."""
    from repro_torch.quant import core as qcore
    rng = np.random.default_rng(seed)
    b = 6
    nb = 1 + b * mb
    k = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d))
                         .astype(np.float32))
    fmt = qcore.get_format(fmt_name)
    if fmt is None:
        pools = [k.to(torch.bfloat16), v.to(torch.bfloat16), None, None]
    else:
        (qk, sk), (qv, sv) = (qcore.quantize_lastdim(x, fmt) for x in (k, v))
        pools = [qk, qv, sk.contiguous(), sv.contiguous()]
    table = torch.from_numpy((1 + rng.permutation(nb - 1)).reshape(b, mb)
                             .astype(np.int32))
    lens = torch.tensor([max(n, w) for n in (31, 32, 33, 64, 1, mb * bs)],
                        dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((b, w, hq, d))
                         .astype(np.float32)).to(torch.bfloat16)
    c = dict(q=q, kpool=pools[0], vpool=pools[1], kscale=pools[2],
             vscale=pools[3], table=table, lens=lens, offs=lens - w)
    return {k: None if x is None else x.cuda() for k, x in c.items()}


def _cuda(t, sl=slice(None), mb=None, q=None, lens=None, offs=None):
    table = t["table"][sl] if mb is None else t["table"][sl, :mb]
    return tpa.paged_attention_cuda(
        (t["q"] if q is None else q)[sl].contiguous(), t["kpool"],
        t["vpool"], table.contiguous(),
        (t["lens"] if lens is None else lens)[sl].contiguous(),
        (t["offs"] if offs is None else offs)[sl].contiguous(),
        kscale=t["kscale"], vscale=t["vscale"])


@pytest.mark.parametrize("fmt_name", DTYPES)
@pytest.mark.parametrize("w", (1, 5))
def test_cuda_split_edges_and_invariance(fmt_name, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    t = _split_case(fmt_name, w)
    before = ops.launches["paged_attention"]
    got = _cuda(t)
    assert ops.launches["paged_attention"] == before + 1   # split + merge
    want = tpa.paged_attention_plain(
        t["q"], t["kpool"], t["vpool"], t["table"], t["lens"], t["offs"],
        kscale=t["kscale"], vscale=t["vscale"])
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-6)
    for j in range(w):                       # width invariance
        narrow = _cuda(t, q=t["q"][:, j:j + 1], lens=t["offs"] + j + 1,
                       offs=t["offs"] + j)
        assert torch.equal(narrow[:, 0], got[:, j])
    for i in range(got.shape[0]):            # batch invariance
        assert torch.equal(_cuda(t, slice(i, i + 1)), got[i:i + 1])
    fits = slice(0, 3)                       # lengths within 5 slots
    assert torch.equal(_cuda(t, fits, mb=5), _cuda(t, fits))


def test_jax_is_cpu():
    assert jax.default_backend() == "cpu"
