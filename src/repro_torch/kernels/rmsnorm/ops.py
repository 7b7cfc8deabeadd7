"""Public fused-RMSNorm op.

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``csrc/rmsnorm.cu``) or raises.
"""

from __future__ import annotations

import torch

from .._build import check, check_inputs, library, stream_of
from .ref import rmsnorm_ref

launches = 0   # kernel launches since the last reset_launch_counts()


def rmsnorm(
    x: torch.Tensor,           # (..., D)
    w: torch.Tensor,           # (D,)
    *,
    eps: float = 1e-6,
    scale_offset: float = 0.0,
) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps, scale_offset=scale_offset)
    check_inputs("rmsnorm", x, w)
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: weight shape {tuple(w.shape)} != ({d},)")
    rows = x.numel() // d if d else 0
    y = torch.empty_like(x)
    if rows == 0:
        return y
    err = library().rmsnorm_fwd(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, eps, scale_offset,
        int(x.dtype == torch.bfloat16), stream_of(x))
    check(err, "rmsnorm")
    global launches
    launches += 1
    return y
