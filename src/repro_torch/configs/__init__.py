"""The registry's architecture configs (one module per arch) and the
shape cells (twin of ``repro.configs``)."""

from repro_torch.configs.registry import REGISTRY, get_config, reduced
from repro_torch.configs.shapes import SHAPES, ShapeCell, shapes_for

__all__ = ["REGISTRY", "SHAPES", "ShapeCell", "get_config", "reduced",
           "shapes_for"]
