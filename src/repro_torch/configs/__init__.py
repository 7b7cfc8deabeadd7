"""Architecture configs: one module per ported architecture.

A copy of ``repro.configs`` whose registry lists only the architectures
the PyTorch port runs so far.
"""

from .base import (
    ModelConfig,
    ShapeConfig,
    SHAPES,
    all_configs,
    get_config,
    register,
    shape_applicable,
    smoke_config,
)

_LOADED = False

ARCH_MODULES = [
    "gemma_2b",
    "recurrentgemma_2b",
    "rwkv6_16b",
]


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib

    for mod in ARCH_MODULES:
        importlib.import_module(f"{__name__}.{mod}")
    _LOADED = True


ARCH_IDS = [
    "gemma-2b",
    "recurrentgemma-2b",
    "rwkv6-1.6b",
]
