"""Plain PyTorch attention (naive softmax over the full score matrix).

Materializes the (Sq, Skv) scores, so it serves the CPU path and the
comparisons with the CUDA kernel. Supports causal masking, sliding
windows (keys in (i - window, i]), ``q_offset`` and GQA (H a multiple of
KVH). Math in f32, result cast to q's dtype; a row with no valid key
gives 0.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,                # (B, H, Sq, D)
    k: torch.Tensor,                # (B, KVH, Skv, D)
    v: torch.Tensor,                # (B, KVH, Skv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,              # absolute position of q[0] (prefill chunks)
) -> torch.Tensor:
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    group = h // kvh
    scale = sm_scale if sm_scale is not None else d ** -0.5

    qf = q.float().reshape(b, kvh, group * sq, d)
    scores = (qf @ k.float().transpose(-1, -2)).reshape(b, h, sq, skv) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None and window > 0:
        mask &= k_pos > q_pos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = torch.where(mask, probs, torch.zeros_like(probs))
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-30)
    out = probs.reshape(b, kvh, group * sq, skv) @ v.float()
    return out.reshape(b, h, sq, d).to(q.dtype)
