"""Config registry: one module per assigned architecture.

The port's own copy of ``repro.configs`` (pure data, no JAX); the CPU
tests hold every config equal to the JAX package's.

``get_config(arch_id)`` returns the exact assigned ModelConfig;
``get_config(arch_id, reduced=True)`` returns the CPU smoke-test variant.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, MoEConfig, RGLRUConfig,
                                      ShapeConfig, SHAPES, SSMConfig,
                                      shape_applicable)

ARCHS = [
    "qwen3_moe_30b_a3b",
    "granite_moe_3b_a800m",
    "qwen15_32b",
    "h2o_danube_3_4b",
    "nemotron_4_340b",
    "minicpm_2b",
    "recurrentgemma_9b",
    "mamba2_130m",
    "whisper_base",
    "internvl2_2b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    cfg = mod.CONFIG
    return cfg.reduced() if reduced else cfg


__all__ = ["ARCHS", "SHAPES", "get_config", "shape_applicable", "ModelConfig",
           "MoEConfig", "SSMConfig", "RGLRUConfig", "ShapeConfig"]
