"""Plain PyTorch RMSNorm: y = x * rsqrt(mean(x^2)+eps) * (off+w).

``scale_offset=1.0`` reproduces the Gemma convention (weight stored as a
delta around 1); ``0.0`` gives the Llama convention. Math in f32, result
cast back to x's dtype, as in the CUDA kernel.
"""

from __future__ import annotations

import torch


def rmsnorm_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    eps: float = 1e-6,
    scale_offset: float = 0.0,
) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (scale_offset + w.float())).to(x.dtype)
