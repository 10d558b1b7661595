"""Guards on the port's boundaries: ``repro_torch``, ``chip_smoke.py`` and
the chip-side scripts under ``tools/`` import neither JAX nor the
reference package, the port's entry points (the numpy bridge included)
run on the GPU unless the caller asks for the CPU, and the kernel entry
points launch nothing on a CPU tensor."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.kernels as tker  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.serving.engine import DecodeEngine  # noqa: E402
from repro_torch.serving.engine import SpecDecodeEngine  # noqa: E402
from repro_torch.serving.faults import (FailoverServer,  # noqa: E402
                                        degraded_engine)
from repro_torch.spec import NGramProposer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_scan_sees_the_package():
    assert len(FILES) > 20
    assert ROOT / "src" / "repro_torch" / "core" / "prng.py" in FILES
    assert {"repro_torch"} <= {m.split(".")[0] for f in FILES
                               for m in _imports(f)}


def test_entry_points_default_to_the_gpu():
    for arch in ("qwen1.5-0.5b", "deepseek-v2-236b"):
        cfg = reduced(get_config(arch))
        params = api.init_params(cfg, device="cpu")
        kv = api.KVCache.build(cfg, max_context=64)
        if torch.cuda.is_available():
            assert DecodeEngine(cfg, params).device.type == "cuda"
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DecodeEngine(cfg, params)
        with pytest.raises(RuntimeError):
            api.init_params(cfg)
        with pytest.raises(RuntimeError):
            kv.init(1)
        assert DecodeEngine(cfg, params, device="cpu").device.type == "cpu"
    arr = np.ones((2, 3), np.float32)
    calls = [lambda: bridge.from_numpy(arr),
             lambda: bridge.params_from_reference({"embed": arr}),
             lambda: bridge.caches_from_reference(({"len": arr},))]
    for call in calls:
        if torch.cuda.is_available():
            call()                             # lands on the card
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert bridge.from_numpy(arr, device="cpu").device.type == "cpu"
    cpu = bridge.caches_from_reference(({"len": arr},), device="cpu")
    assert cpu["len"].device.type == "cpu"


def test_serving_entry_points_default_to_the_gpu():
    """The sampling, speculative and failover entry points: the card
    unless the caller asks for the CPU; the degraded tier follows its
    primary's device."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    params = api.init_params(cfg, device="cpu")
    builds = [lambda: SpecDecodeEngine(cfg, params,
                                       proposer=NGramProposer()),
              lambda: FailoverServer(DecodeEngine(cfg, params)),
              lambda: prng.key(0)]
    for build in builds:
        if torch.cuda.is_available():
            build()
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    if torch.cuda.is_available():
        tier = degraded_engine(DecodeEngine(cfg, params))
        assert tier.device.type == "cuda"
        assert prng.key(0).device.type == "cuda"
    primary = DecodeEngine(cfg, params, device="cpu")
    assert degraded_engine(primary).device.type == "cpu"
    assert FailoverServer(primary).primary.device.type == "cpu"
    assert prng.key(0, device="cpu").device.type == "cpu"


def test_kernel_entry_points_launch_nothing_on_the_cpu():
    ops = tker.ops
    x = torch.ones(4, 256)
    qw = torch.ones(256, 8, dtype=torch.int8)
    before = dict(ops.launches)
    ops.kahan_accumulate(torch.zeros(4, 256), torch.zeros(4, 256), x)
    ops.q8_matmul(x, qw, torch.ones(1, 8))
    ops.batched_kahan_dot(x, x)
    tker.kahan_matmul(x, x.T)
    q = torch.ones(2, 5, 8)
    tker.flash_attention(q, q, q)
    assert ops.launches == before
