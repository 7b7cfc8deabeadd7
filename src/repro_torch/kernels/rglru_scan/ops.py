"""Public RG-LRU scan op.

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``csrc/rglru_scan.cu``) or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._build import check, check_inputs, library, stream_of
from .ref import rglru_scan_ref

launches = 0   # kernel launches since the last reset_launch_counts()


def rglru_scan(
    log_a: torch.Tensor,   # (B, S, D)
    b: torch.Tensor,       # (B, S, D)
    h0: torch.Tensor,      # (B, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All states h_t (B, S, D) and the last state (B, D) of
    h_t = exp(log_a_t) * h_{t-1} + b_t, in b's dtype."""
    if b.device.type == "cpu":
        return rglru_scan_ref(log_a, b, h0)
    check_inputs("rglru_scan", log_a, b, h0)
    if b.dim() != 3 or log_a.shape != b.shape or h0.shape != (b.shape[0], b.shape[2]):
        raise ValueError(f"rglru_scan: log_a {tuple(log_a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)}; want (B, S, D), (B, S, D), (B, D)")
    bsz, s, d = b.shape
    hs = torch.empty_like(b)
    hlast = torch.empty_like(h0)
    err = library().rglru_scan_fwd(
        log_a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(), hlast.data_ptr(),
        bsz, s, d, int(b.dtype == torch.bfloat16), stream_of(b))
    check(err, "rglru_scan")
    global launches
    launches += 1
    return hs, hlast
