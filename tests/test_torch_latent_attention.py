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

The CUDA kernel's arithmetic (csrc/paged_latent_attention.cu) is
emulated in torch ops: q, p and f32 pools as exact bf16 planes, the
plane products in the kernel's accumulators, fixed partitions of table
slots walked in groups of padded keys (the group's max, then a Neumaier
fold per slot), and the merge of the partitions in index order, a chunk
of partitions at a time; it is held to the reference kernel at the
reference's latent tolerance, 2e-4. The emulation holds its own copies
of the kernel's partition, group and chunk sizes, which the GPU tests
check against the library. On the card, the kernel against the twin,
with width, batch and table-width invariance bitwise, and a long table
whose scratch stays one chunk's.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.models import paged as rpaged  # noqa: E402
from repro.quant import core as rq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import kahan as tkahan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.quant import core as tq  # noqa: E402

K_DRAFT = 4
DTYPES = ("bf16", "int8", "fp8")
B, H, C, R, BS, MB = 2, 3, 16, 8, 8, 3
SCALE = (16 + 8) ** -0.5            # (nope + rope)^-0.5 of a small MLA
# csrc/paged_latent_attention.cu's table slots per partition, padded keys
# per group (one-plane pools, f32 pools) and partitions per chunk
SLOTS, GROUP_KEYS, GROUP_KEYS_F32, CHUNK = 4, 64, 16, 32


def _case(fmt_name, w, seed=11, rope_dtype=jnp.bfloat16, mb=MB, lens=None):
    """Reference-built latent pools (numpy, blocks permuted) + inputs;
    ``fmt_name`` "f32" keeps f32 pools."""
    rng = np.random.default_rng(seed)
    layout = rpaged.PagedLayout(BS, mb)
    rows_c = jnp.asarray(rng.standard_normal((B, mb * BS, C))
                         .astype(np.float32))
    rows_r = jnp.asarray(rng.standard_normal((B, mb * BS, R))
                         .astype(np.float32))
    fmt = None if fmt_name == "f32" else rq.get_format(fmt_name)
    if fmt is None:
        pdt = jnp.float32 if fmt_name == "f32" else jnp.bfloat16
        pools = [rpaged.pool_from_rows(x.astype(pdt), layout)
                 for x in (rows_c, rows_r)] + [None, None]
    else:
        (qc, sc), (qr, sr) = (rq.quantize_lastdim(x, fmt)
                              for x in (rows_c, rows_r))
        pools = [rpaged.pool_from_rows(a, layout) for a in (qc, qr, sc, sr)]
    perm = np.concatenate([[0], 1 + rng.permutation(B * mb)]).astype(np.int32)
    inv = np.argsort(perm)
    pools = [None if p is None else np.asarray(p)[inv] for p in pools]
    table = perm[np.asarray(rpaged.identity_table(B, layout))]
    lens = np.array([w + 2, 2 * BS + 3] if lens is None else lens, np.int32)
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
    mb = t["table"].shape[1]

    def rows(pool, scale):
        x = tq.cast_f32(pool[t["table"].long()].reshape(B, mb * BS, -1))
        if scale is not None:
            x = x * scale[t["table"].long()].reshape(B, mb * BS)[..., None]
        return x.double()
    ck, kr = rows(t["ck"], t["cs"]), rows(t["kr"], t["rs"])
    s = (torch.einsum("bwhc,bsc->bwhs", t["q_lat"].double(), ck)
         + torch.einsum("bwhr,bsr->bwhs", t["q_rope"].double(), kr)) * SCALE
    w = t["q_lat"].shape[1]
    lim = t["offs"].long()[:, None] + torch.arange(w)[None, :]
    mask = torch.arange(mb * BS)[None, None, None, :] <= lim[:, :, None, None]
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


# -------------------------------------------- the kernel's arithmetic --

def _split3(x):
    """Exact bf16 planes of f32 x, largest first: hi + mid + lo == x."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, r - mid


def _pool_planes(x):
    """A pool tile's planes: three for f32, one for bf16 / int8 / fp8."""
    return _split3(x) if x.dtype == torch.float32 else (tq.cast_f32(x),)


def _products(a, b):
    """The plane products a_i @ b_jᵀ (i + j <= 2) the kernel issues:
    (hi.hi, the others summed smallest first)."""
    pairs = sorted(((i, j) for i in range(len(a)) for j in range(len(b))
                    if i + j <= 2), key=lambda ij: -(ij[0] + ij[1]))
    small = torch.zeros(a[0].shape[0], b[0].shape[0])
    for i, j in pairs[:-1]:
        small = small + a[i] @ b[j].T
    return a[0] @ b[0].T, small


def _fold(s, c, x, y):
    """(s, c) += (x, y): TwoSum of the sums, the carries to the carry."""
    t, e = tkahan.twosum(s, x)
    return t, c + (e + y)


def _emulate_latent(t, chunk=CHUNK):
    """csrc/paged_latent_attention.cu's arithmetic in torch ops, with
    ``chunk`` partitions per chunk of the merge."""
    ql, qr = t["q_lat"], t["q_rope"]
    b, w, h, c = ql.shape
    rows = w * h
    ck, kr, cs, rs = t["ck"], t["kr"], t["cs"], t["rs"]
    bs, mb = ck.shape[1], t["table"].shape[1]
    quant = cs is not None
    slots = SLOTS
    gs = (GROUP_KEYS_F32 if ck.dtype == torch.float32 else GROUP_KEYS) \
        // (-(-bs // 16) * 16)
    out = torch.zeros(b, rows, c)
    for bi in range(b):
        qp = _split3(ql[bi].reshape(rows, c).float())
        rp = _split3(qr[bi].reshape(rows, -1).float())
        n = int(t["lens"][bi])
        live = min(mb, -(-n // bs)) if n > 0 else 0
        lim = int(t["offs"][bi]) + 1 + torch.arange(rows) // h
        parts = []
        for j0 in range(0, live, slots):
            jend = min(j0 + slots, live)
            m = torch.full((rows,), tpa.NEG_INF)
            ls, lc = torch.zeros(rows), torch.zeros(rows)
            acs, acc = torch.zeros(rows, c), torch.zeros(rows, c)
            for jg in range(j0, jend, gs):
                group = list(range(jg, min(jg + gs, jend)))
                blk = t["table"][bi, group].long()
                kpos = (torch.tensor(group)[:, None] * bs
                        + torch.arange(bs)[None, :]).reshape(-1)
                ckp = _pool_planes(ck[blk].reshape(len(group) * bs, c))
                krp = _pool_planes(kr[blk].reshape(len(group) * bs, -1))
                big, small = _products(qp, ckp)
                rope_big, rope_small = _products(rp, krp)
                lat, rope = big + small, rope_small + rope_big
                if quant:
                    cs_k = cs[blk].reshape(-1)
                    s = lat * cs_k + rope * rs[blk].reshape(-1)
                else:
                    s = lat + rope
                mask = kpos[None, :] < lim[:, None]
                s = torch.where(mask, s * SCALE, tpa.NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                m = m_new
                p = torch.exp(s - m_new[:, None]) * mask
                pp = _split3(p * cs_k if quant else p)
                for si in range(len(group)):
                    keys = slice(si * bs, (si + 1) * bs)
                    cr = corr if si == 0 else torch.ones(rows)
                    ls, lc = tkahan.neumaier_step(ls * cr, lc * cr,
                                                  p[:, keys].sum(-1))
                    pb, ps = _products(tuple(x[:, keys] for x in pp),
                                       tuple(x[keys].T for x in ckp))
                    acs, acc = tkahan.neumaier_step(
                        acs * cr[:, None], acc * cr[:, None], pb + ps)
            parts.append((m, ls, lc, acs, acc))
        if not parts:
            continue
        held = None                  # the state of the chunks before
        for k0 in range(0, len(parts), chunk):
            now = parts[k0:k0 + chunk]
            mm = torch.stack([p[0] for p in now]
                             + ([held[0]] if held else [])).amax(0)
            sl, cl = torch.zeros(rows), torch.zeros(rows)
            sa, ca = torch.zeros(rows, c), torch.zeros(rows, c)
            for m, ls, lc, acs, acc in [held] * bool(held) + now:
                cr = torch.exp(m - mm)        # the state, then index order
                sl, cl = _fold(sl, cl, ls * cr, lc * cr)
                sa, ca = _fold(sa, ca, acs * cr[:, None], acc * cr[:, None])
            held = (mm, sl, cl, sa, ca)
        out[bi] = (sa + ca) / torch.clamp_min(sl + cl, 1e-30)[:, None]
    return out.reshape(b, w, h, c)


@pytest.mark.parametrize("fmt_name", DTYPES + ("f32",))
@pytest.mark.parametrize("w", (1, K_DRAFT + 1))
def test_kernel_emulation_matches_reference(fmt_name, w):
    """Three partitions of 4 slots (32 tokens) on a 12-slot table: one
    sequence ends on a partition edge (64 tokens), the other inside one.
    f32 pools take groups of one slot, so their partitions walk four
    groups through the scratch."""
    c = _case(fmt_name, w, seed=17, mb=12, lens=[64, 45])
    t = _t(c)
    got = _emulate_latent(t)
    np.testing.assert_allclose(got.numpy(), _ref(c), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), _port(t).numpy(), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("chunk", (1, 2))
@pytest.mark.parametrize("fmt_name", ("bf16", "f32"))
def test_kernel_emulation_chunked_merge_matches_reference(fmt_name, chunk):
    """The merge a chunk at a time (the state of the chunks before folded
    first), at chunks of one and two partitions so that a 12-slot table
    takes three and two; the kernel's chunk of 32 partitions comes in the
    long-table case below."""
    c = _case(fmt_name, K_DRAFT + 1, seed=23, mb=12, lens=[96, 45])
    t = _t(c)
    np.testing.assert_allclose(_emulate_latent(t, chunk).numpy(), _ref(c),
                               atol=2e-4, rtol=2e-4)


def test_kernel_emulation_long_table_matches_reference():
    """A 132-slot table: 33 partitions, two chunks of the kernel's 32."""
    c = _case("int8", 1, seed=29, mb=132, lens=[132 * BS, 1000])
    np.testing.assert_allclose(_emulate_latent(_t(c)).numpy(), _ref(c),
                               atol=2e-4, rtol=2e-4)


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


@pytest.mark.parametrize("fmt_name", DTYPES + ("f32",))
def test_cuda_partitions_and_invariance(fmt_name):
    """On the card: lengths on and beside the partition edges (32 tokens)
    against the twin, then bitwise batch invariance (each sequence alone)
    and table-width invariance (the same slots in a wider table)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    t = {k: None if v is None else v.cuda() for k, v in
         _t(_case(fmt_name, K_DRAFT + 1, seed=19, mb=12,
                  lens=[64, 33])).items()}
    kw = dict(ck_scale=t["cs"], kr_scale=t["rs"], scale=SCALE)

    def call(table, lens, offs, sl=slice(None)):
        return tpa.paged_latent_attention_cuda(
            t["q_lat"][sl].contiguous(), t["q_rope"][sl].contiguous(),
            t["ck"], t["kr"], table[sl].contiguous(), lens[sl].contiguous(),
            offs[sl].contiguous(), **kw)
    got = call(t["table"], t["lens"], t["offs"])
    want = tpa.paged_latent_attention_plain(
        t["q_lat"], t["q_rope"], t["ck"], t["kr"], t["table"], t["lens"],
        t["offs"], **kw)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    for i in range(B):
        assert torch.equal(call(t["table"], t["lens"], t["offs"],
                                slice(i, i + 1)), got[i:i + 1])
    wide = torch.cat([t["table"], torch.zeros_like(t["table"])], dim=1)
    assert torch.equal(call(wide, t["lens"], t["offs"]), got)


def test_cuda_library_geometry_matches_emulation():
    """The emulation's copies of the kernel's partition, chunk and group
    sizes are the library's: the smem query, and so the wrapper, refuse a
    block one key past a group (and a C that is no multiple of 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    lib = tpa._latent_lib()
    assert lib.repro_paged_latent_attention_slots() == SLOTS
    assert lib.repro_paged_latent_attention_chunk() == CHUNK
    for dt, keys in ((torch.bfloat16, GROUP_KEYS), (torch.int8, GROUP_KEYS),
                     (torch.float32, GROUP_KEYS_F32)):
        code = tpa._POOL_TYPES[dt]
        assert lib.repro_paged_latent_attention_smem(C, R, code, keys) > 0
        assert lib.repro_paged_latent_attention_smem(C, R, code,
                                                     keys + 1) == -1
    dev = torch.device("cuda")
    for dt, bs, c in ((torch.bfloat16, GROUP_KEYS + 1, C),
                      (torch.float32, GROUP_KEYS_F32 + 1, C),
                      (torch.bfloat16, BS, C + 4)):
        with pytest.raises(ValueError):        # the wrapper refuses them
            tpa.paged_latent_attention_cuda(
                torch.zeros(1, 1, H, c, device=dev),
                torch.zeros(1, 1, H, R, device=dev, dtype=torch.bfloat16),
                torch.zeros(2, bs, c, device=dev, dtype=dt),
                torch.zeros(2, bs, R, device=dev, dtype=dt),
                torch.ones(1, 1, dtype=torch.int32, device=dev),
                torch.ones(1, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), scale=SCALE)


def test_cuda_long_table_scratch_is_one_chunk():
    """A 1024-slot table (16384 tokens at bs 16, 256 partitions, eight
    chunks) at deepseek-v2's latent widths: against the twin at 2e-4, the
    scratch one chunk's (plus the state), read from the allocator's peak,
    and bitwise width, batch and table-width invariance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    b, w, h, c, r, bs, mb = 2, 2, 16, 512, 64, 16, 1024
    ck = torch.randn(b * mb + 1, bs, c, generator=g, device=dev).bfloat16()
    kr = torch.randn(b * mb + 1, bs, r, generator=g, device=dev).bfloat16()
    table = (1 + torch.randperm(b * mb, generator=g, device=dev)).reshape(
        b, mb).int()
    lens = torch.tensor([mb * bs, 3000], dtype=torch.int32, device=dev)
    offs = lens - w
    q_lat = torch.randn(b, w, h, c, generator=g, device=dev)
    q_rope = torch.randn(b, w, h, r, generator=g, device=dev).bfloat16()
    scale = (128 + 64) ** -0.5

    def call(tb=table, ln=lens, of=offs, sl=slice(None), ws=slice(None)):
        return tpa.paged_latent_attention_cuda(
            q_lat[sl, ws].contiguous(), q_rope[sl, ws].contiguous(), ck, kr,
            tb[sl].contiguous(), ln[sl].contiguous(), of[sl].contiguous(),
            scale=scale)
    rows = w * h
    stride = -(-3 * rows // 4) * 4 + 2 * rows * c
    floats = tpa.latent_scratch_floats(b, rows, c, mb)
    assert floats == b * (CHUNK + 1) * stride
    assert floats == tpa.latent_scratch_floats(b, rows, c, SLOTS * CHUNK + 1)
    assert tpa.latent_scratch_floats(b, rows, c, SLOTS * CHUNK) == \
        b * CHUNK * stride
    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    got = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    # the table's 256 partitions would be 8x the chunk's 33
    assert peak <= 4 * (floats + got.numel()) + (4 << 20)
    want = tpa.paged_latent_attention_plain(q_lat, q_rope, ck, kr, table,
                                            lens, offs, scale=scale)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    for j in range(w):
        assert torch.equal(call(ln=offs + j + 1, of=offs + j,
                                ws=slice(j, j + 1))[:, 0], got[:, j])
    for i in range(b):
        assert torch.equal(call(sl=slice(i, i + 1)), got[i:i + 1])
    wide = torch.cat([table, table[:, :100]], dim=1)
    assert torch.equal(call(tb=wide), got)
    assert torch.equal(call(tb=table[:, :188], sl=slice(1, 2)), got[1:2])
