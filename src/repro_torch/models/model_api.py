"""Uniform Model facade over the architecture families ported so far:
dense (``transformer``), griffin and rwkv6.

``build_model(cfg, device=...)`` returns a ``Model`` exposing:
  * ``defs`` / ``init`` / ``n_params`` — parameter tree declaration and
    materialization on the model's device;
  * ``forward`` / ``loss`` — full-sequence compute;
  * ``cache_defs`` / ``init_cache`` — decode state;
  * ``decode_step`` — single-token decode.

Parameters are a tree of tensors passed to every call, as in the JAX
package; the Model holds the configuration and the device.
"""

from __future__ import annotations

from typing import Any, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import griffin, rwkv6, transformer
from .layers import init_params, param_count

_FAMILY = {
    "dense": transformer,
    "griffin": griffin,
    "rwkv6": rwkv6,
}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist.
    ``"cuda"`` resolves to the current card, as the tensors made there report."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, mod: Any, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        self.mod = mod
        self.device = device

    # ------------------------------------------------------------- params
    @property
    def defs(self):
        return self.mod.model_defs(self.cfg)

    def init(self, seed: int = 0):
        """Random parameters on the model's device from a seeded generator."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.defs, gen, self.cfg)

    def n_params(self) -> int:
        return param_count(self.defs)

    # ------------------------------------------------------------ compute
    def forward(self, params, batch, *, last_only: bool = False):
        return self.mod.forward(self.cfg, params, batch, last_only=last_only)

    def loss(self, params, batch):
        return self.mod.loss_fn(self.cfg, params, batch)

    # ------------------------------------------------------------- decode
    def cache_defs(self, batch: int, max_len: int):
        return self.mod.cache_defs(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int):
        """A zeroed cache on the model's device."""
        gen = torch.Generator(device=self.device)
        return init_params(self.cache_defs(batch, max_len), gen, self.cfg)

    def decode_step(self, params, cache, tokens, lengths):
        return self.mod.decode_step(self.cfg, params, cache, tokens, lengths)


def build_model(cfg: ModelConfig, device: Union[str, torch.device] = "cuda") -> Model:
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet "
            f"(ported: {', '.join(sorted(_FAMILY))})")
    return Model(cfg=cfg, mod=_FAMILY[cfg.family], device=resolve_device(device))
