"""Assigned-architecture configs (--arch <id>): the port's copy of the
JAX package's ``configs``, data only."""
from .base import (ArchConfig, MambaCfg, MoECfg, RWKVCfg, EncDecCfg,
                   VisionStubCfg, ShapeCfg, SHAPES, all_archs, get_arch,
                   layer_kinds, register_arch, shape_applicable)

__all__ = ["ArchConfig", "MambaCfg", "MoECfg", "RWKVCfg", "EncDecCfg",
           "VisionStubCfg", "ShapeCfg", "SHAPES", "all_archs", "get_arch",
           "layer_kinds", "register_arch", "shape_applicable"]
