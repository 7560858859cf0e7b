"""Architecture config registry."""
from .archs import ARCHS
from .base import LayerSpec, ModelConfig


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]()


def list_archs():
    return sorted(ARCHS)
