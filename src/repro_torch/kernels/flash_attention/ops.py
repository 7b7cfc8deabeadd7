"""Public flash-attention op (forward).

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``csrc/flash_attention.cu``) or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._build import check, check_inputs, library, stream_of
from .ref import attention_ref

launches = 0   # kernel launches since the last reset_launch_counts()
HEAD_DIMS = (16, 64, 128, 256)   # the widths csrc/flash_attention.cu builds


def flash_attention(
    q: torch.Tensor,                  # (B, H, Sq, D)
    k: torch.Tensor,                  # (B, KVH, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale, q_offset=q_offset)
    check_inputs("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} with k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)}")
    kvh, skv = k.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} q heads on {kvh} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} is not one of {HEAD_DIMS}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: operands must be 16-byte aligned")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kvh, sq, skv, d, scale, int(causal), int(window or 0), int(q_offset),
        int(q.dtype == torch.bfloat16), stream_of(q))
    check(err, "flash_attention")
    global launches
    launches += 1
    return out
