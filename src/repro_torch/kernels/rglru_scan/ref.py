"""Plain PyTorch gated linear recurrence  h_t = exp(log_a_t) * h_{t-1} + b_t.

A loop over the sequence in f32 from h0; returns every h_t and the last
one, both in b's dtype, as the CUDA kernel and the JAX reference do.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rglru_scan_ref(
    log_a: torch.Tensor,   # (B, S, D) log decay per step (<= 0)
    b: torch.Tensor,       # (B, S, D) pre-gated input
    h0: torch.Tensor,      # (B, D) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    a = torch.exp(log_a.float())
    bf = b.float()
    h = h0.float()
    hs = torch.empty_like(bf)
    for t in range(bf.shape[1]):
        h = a[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs.to(b.dtype), h.to(b.dtype)
