"""Guards on the port's boundaries: ``repro_torch`` and ``chip_smoke.py``
import neither JAX nor the reference package, and the port's entry
points run on the GPU unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving.engine import DecodeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
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
    assert {"repro_torch"} <= {m.split(".")[0] for f in FILES
                               for m in _imports(f)}


def test_entry_points_default_to_the_gpu():
    cfg = reduced(get_config("qwen1.5-0.5b"))
    params = api.init_params(cfg, device="cpu")
    kv = api.KVCache.build(cfg, max_context=64)
    if torch.cuda.is_available():
        assert DecodeEngine(cfg, params).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(cfg, params)
    with pytest.raises(RuntimeError):
        api.init_params(cfg)
    with pytest.raises(RuntimeError):
        kv.init(1)
    assert DecodeEngine(cfg, params, device="cpu").device.type == "cpu"
