"""Carry the JAX package's parameter and cache trees into the port.

The trees are nested dicts of numpy arrays (``np.asarray`` of each JAX
leaf), so this module needs no JAX. With ``scan_layers`` the JAX tree
stacks every layer's parameters on a leading axis under ``"layers"``
(``repro.models.layers.stack_defs``); the port keeps a list of per-layer
trees, so that axis is unstacked here, in parameters and decode caches
alike (gemma-2b's KV cache and rwkv6's recurrent state are stacked). A
family whose layers differ (griffin) is a list of per-layer trees on both
sides and is carried across layer by layer. bf16 arrays (numpy's ml_dtypes ``bfloat16``) are
carried through f32 without rounding.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .layers import ParamDef, torch_dtype
from .model_api import Model


def _tensor(a: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)   # a writable copy


def _load(defs: Any, tree: Any, model: Model, path: str) -> Any:
    if isinstance(defs, ParamDef):
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(defs.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {defs.shape}")
        return _tensor(arr, torch_dtype(defs.dtype or model.cfg.dtype), model.device)
    if isinstance(defs, dict):
        if set(defs) != set(tree):
            raise KeyError(f"{path}: keys {sorted(tree)} != {sorted(defs)}")
        return {k: _load(v, tree[k], model, f"{path}/{k}") for k, v in defs.items()}
    if isinstance(defs, list):
        if isinstance(tree, dict):   # scanned layers: unstack the leading axis
            n = len(defs)
            tree = [_index(tree, i, n) for i in range(n)]
        if len(tree) != len(defs):
            raise ValueError(f"{path}: {len(tree)} layers != {len(defs)}")
        return [_load(d, t, model, f"{path}/{i}") for i, (d, t) in enumerate(zip(defs, tree))]
    raise TypeError(f"{path}: unexpected definition node {type(defs)}")


def _index(tree: Any, i: int, n: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i, n) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.shape[0] != n:
        raise ValueError(f"stacked layer axis {arr.shape[0]} != {n} layers")
    return arr[i]


def load_jax_params(model: Model, tree: Any) -> Any:
    """The port's parameter tree, on the model's device, from a JAX one."""
    return _load(model.defs, tree, model, "params")


def load_jax_cache(model: Model, tree: Any, batch: int, max_len: int) -> Any:
    """The port's decode cache, on the model's device, from a JAX one made
    by ``init_cache(batch, max_len)``. The caller names ``batch``, as it
    names ``max_len``: a stacked (``scan_layers``) JAX tree has the layer
    count, not the batch, on its leaves' first axis."""
    return _load(model.cache_defs(batch, max_len), tree, model, "cache")
