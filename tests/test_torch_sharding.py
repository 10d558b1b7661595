"""The port's sharding rules (``repro_torch.distributed.sharding``) and
the schema helpers they read (``models.common.logical_axes_tree``,
``abstract_params``, ``count_params``, ``data.synthetic``'s batch
structs) against the reference's, for all ten registry configs at full
width, on the meshes the reference plans for: (2, 2, 2) and (4, 2) (its
test meshes), (16, 16) and (2, 16, 16) (one pod and two).

The reference's specs come from ``jax.sharding.AbstractMesh`` (axis
names and sizes, no devices); the port's from the same names and sizes
as a plain mapping. Specs are compared exactly, entry by entry: a
``PartitionSpec``'s entries against the port's tuple.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.distributed import sharding as rsh  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import common as rcommon  # noqa: E402
from repro.models import paged as rpaged  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import paged as tpaged  # noqa: E402

ARCHS = list(rreg.REGISTRY)
MESHES = {"(2, 2, 2)": ((2, 2, 2), ("pod", "data", "model")),
          "(4, 2)": ((4, 2), ("data", "model")),
          "(16, 16)": ((16, 16), ("data", "model")),
          "(2, 16, 16)": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"default": (rsh.DEFAULT_RULES, tsh.DEFAULT_RULES),
         "pod_fsdp": (rsh.POD_FSDP_RULES, tsh.POD_FSDP_RULES),
         "pure_dp": (rsh.PURE_DP_RULES, tsh.PURE_DP_RULES)}
BATCHES = (1, 8, 256)


def _meshes(name):
    sizes, names = MESHES[name]
    return (jax.sharding.AbstractMesh(sizes, names),
            dict(zip(names, sizes)))


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (tuples and specs are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _ref_spec(s):
    spec = s.spec if hasattr(s, "spec") else s
    return tuple(spec)


def test_rules_tables_are_the_references():
    for ref, port in RULES.values():
        assert ref == port
    assert rsh.ACT_RULES_DEFAULT == tsh.ACT_RULES_DEFAULT


@pytest.mark.parametrize("arch", ARCHS)
def test_schema_helpers(arch):
    rs, ts = rapi.schema(rreg.get_config(arch)), \
        tapi.schema(treg.get_config(arch))
    assert tcommon.count_params(ts) == rcommon.count_params(rs)
    assert _flat(tcommon.logical_axes_tree(ts)) == \
        _flat(rcommon.logical_axes_tree(rs))
    ra = _flat(rcommon.abstract_params(rs))
    ta = _flat(tcommon.abstract_params(ts))
    assert list(ta) == list(ra)
    for k, v in ta.items():
        assert v.device.type == "meta", k
        assert tuple(v.shape) == tuple(ra[k].shape), k
        assert str(v.dtype)[6:] == str(ra[k].dtype), k


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs(arch, mesh):
    rmesh, tmesh = _meshes(mesh)
    rs, ts = rapi.schema(rreg.get_config(arch)), \
        tapi.schema(treg.get_config(arch))
    for rules, (rrules, trules) in RULES.items():
        want = {k: _ref_spec(v) for k, v in
                _flat(rsh.param_specs(rs, rmesh, rrules)).items()}
        got = _flat(tsh.param_specs(ts, tmesh, trules))
        assert got == want, (rules, {k: (got[k], want[k]) for k in got
                                     if got[k] != want.get(k)})


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs(arch, mesh):
    rmesh, tmesh = _meshes(mesh)
    rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
    seq = 2048 if rcfg.family == "vlm" else 256
    for gb in BATCHES:
        for kind in ("train", "prefill"):
            rfn = getattr(rsyn, f"{kind}_batch_struct")
            tfn = getattr(tsyn, f"{kind}_batch_struct")
            rb, tb = rfn(rcfg, seq, gb), tfn(tcfg, seq, gb)
            assert {k: (tuple(v.shape), str(v.dtype)[6:])
                    for k, v in tb.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in rb.items()}
            assert {k: s.spec for k, s in
                    tsh.batch_shardings(tb, tmesh, gb).items()} == \
                {k: tuple(rsh.data_batch_spec(rmesh, gb, len(v.shape)))
                 for k, v in rb.items()}
        tok = tsyn.decode_tokens_struct(gb)
        assert tuple(tok.shape) == rsyn.decode_tokens_struct(gb).shape
        assert tsh.batch_shardings(tok, tmesh, gb).spec == \
            tuple(rsh.data_batch_spec(rmesh, gb, 2))
        assert tsh.batch_axes(tmesh, gb) == rsh.batch_axes(rmesh, gb)
        for num_blocks in (None, 512):
            rcs = rapi.cache_specs(rcfg, gb, rpaged.PagedLayout.for_context(
                1024), num_blocks=num_blocks)
            tcs = tapi.cache_specs(tcfg, gb, tpaged.PagedLayout.for_context(
                1024), num_blocks=num_blocks)
            rshard = rsh.serve_cache_shardings(rcfg, rcs, rmesh, gb)
            tshard = tsh.serve_cache_shardings(tcfg, tcs, tmesh, gb)
            # the reference's lm caches are a tuple of stacks (MLA's dense
            # first layer apart); the port's one stack carries the same
            # per-leaf specs
            rstacks = rshard if isinstance(rshard, tuple) else (rshard,)
            for stack in rstacks:
                want = {k: _ref_spec(v) for k, v in _flat(stack).items()}
                got = {k: v.spec for k, v in _flat(tshard).items()}
                assert got == want, (gb, num_blocks, got, want)
            # cache_spec_for alone, on every non-pool leaf
            for k, v in _flat(tcs).items():
                name = k.rsplit("/", 1)[-1]
                if name in tpaged.POOL_KEYS or name == "block_table":
                    continue
                lead = 2 if (tcfg.family == "hybrid"
                             and k.startswith("mamba")) else 1
                shape = jax.ShapeDtypeStruct(v[0], jax.numpy.float32)
                assert tsh.cache_spec_for(v, tmesh, gb, stacked=lead) == \
                    tuple(rsh.cache_spec_for(shape, rmesh, gb,
                                             stacked=lead)), k


def test_spec_for_axes_invariants():
    """A mesh axis is used once per spec (the first logical axis wins),
    and a dim that its axes do not divide stays replicated."""
    rmesh, tmesh = _meshes("(16, 16)")
    for axes, shape in ((("experts", "embed", "mlp"), (160, 5120, 1536)),
                        (("vocab", "embed"), (50280, 2560)),
                        (("embed", "embed_out"), (1024, 1024)),
                        (("layers", "q_heads", None), (24, 48, 7))):
        assert tsh.spec_for_axes(axes, tmesh, shape, tsh.DEFAULT_RULES) == \
            tuple(rsh.spec_for_axes(axes, rmesh, shape, rsh.DEFAULT_RULES))
    assert tsh.spec_for_axes(("experts", "embed", "mlp"), tmesh,
                             (160, 5120, 1536), tsh.DEFAULT_RULES) == \
        ("model", "data", None)
    assert tsh.spec_for_axes(("vocab", "embed"), tmesh, (50280, 2560),
                             tsh.DEFAULT_RULES) == (None, "data")


def test_shard_act_is_the_identity_outside_a_mesh():
    x = torch.randn(2, 3, 4, 5)
    assert tsh.shard_act(x, "act_batch", "act_seq", "act_heads", None) is x
    # inside a context a plain tensor passes through too
    with tsh.activation_sharding({"data": 1, "model": 1}):
        assert tsh.shard_act(x, "act_batch", "act_seq", "act_heads",
                             None) is x
    assert tsh._ACT_CTX.get() is None
