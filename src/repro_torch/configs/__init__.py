from repro_torch.configs.registry import REGISTRY, get_config, reduced

__all__ = ["REGISTRY", "get_config", "reduced"]
