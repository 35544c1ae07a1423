from .base import ArchConfig, ShapeSpec, SHAPES, ARCH_IDS, cells, shape_supported
from .registry import get_config, all_configs, smoke_config

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "cells", "shape_supported", "get_config", "all_configs", "smoke_config"]
