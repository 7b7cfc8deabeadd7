"""Public decode-attention op.

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``csrc/decode_attention.cu``) or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._build import check, check_inputs, library, stream_of
from .ref import decode_attention_ref

GROUPS = (1, 2, 3, 4, 8, 10, 16)   # q heads per kv head the kernel is built for
launches = 0   # kernel launches since the last reset_launch_counts()


def decode_attention(
    q: torch.Tensor,          # (B, H, D)
    k: torch.Tensor,          # (B, KVH, S, D)
    v: torch.Tensor,          # (B, KVH, S, D)
    lengths: torch.Tensor,    # (B,) int32
    *,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, sm_scale=sm_scale, window=window)
    check_inputs("decode_attention", q, k, v)
    b, h, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} with cache "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    kvh, s = k.shape[1], k.shape[2]
    if h % kvh or h // kvh not in GROUPS:
        raise ValueError(f"decode_attention: {h} q heads on {kvh} kv heads; "
                         f"the kernel takes groups {GROUPS}")
    if d % 8 or d > 256:
        raise ValueError(f"decode_attention: head_dim {d} must be a multiple of 8, <= 256")
    if (lengths.device != q.device or lengths.dtype != torch.int32
            or lengths.shape != (b,) or not lengths.is_contiguous()):
        raise ValueError("decode_attention: lengths must be a contiguous (B,) int32 "
                         "tensor on q's device")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: operands must be 16-byte aligned")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if b == 0:
        return out
    err = library().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, kvh, s, d, scale, int(window or 0), int(q.dtype == torch.bfloat16),
        stream_of(q))
    check(err, "decode_attention")
    global launches
    launches += 1
    return out
