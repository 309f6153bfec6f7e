"""Architecture configs ported so far."""
from repro_torch.configs.base import (PORTED, SHAPES, ArchConfig, LayerGroup, MLAConfig,
                                      SALRModelConfig, ShapeSpec, get, register)

__all__ = ["PORTED", "SHAPES", "ArchConfig", "LayerGroup", "MLAConfig",
           "SALRModelConfig", "ShapeSpec", "get", "register"]
