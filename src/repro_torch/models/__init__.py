"""Model substrate: the dense, griffin and rwkv6 families behind one Model facade."""

from .model_api import Model, build_model

__all__ = ["Model", "build_model"]
