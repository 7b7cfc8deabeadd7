"""Plain PyTorch decode attention over a KV cache.

GQA is computed with grouped einsums — q reshaped to (B, KVH, G, D) —
rather than repeating the cache. Math in f32 (scores, probabilities and
the weighted sum), result cast to q's dtype, as in the CUDA kernel. A
length above S counts as S; a sequence with no valid position gives 0.
"""

from __future__ import annotations

from typing import Optional

import torch


def decode_attention_ref(
    q: torch.Tensor,          # (B, H, D) — one new token per sequence
    k: torch.Tensor,          # (B, KVH, S, D) — cache (padded to S)
    v: torch.Tensor,          # (B, KVH, S, D)
    lengths: torch.Tensor,    # (B,) int32 — valid cache entries per sequence
    *,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    group = h // kvh
    scale = sm_scale if sm_scale is not None else d ** -0.5

    qg = q.float().reshape(b, kvh, group, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    pos = torch.arange(s, device=q.device)[None, :]
    lens = lengths.to(q.device, torch.int64)[:, None]
    mask = pos < lens
    if window is not None and window > 0:
        mask &= pos >= lens - window
    mask4 = mask[:, None, None, :]
    scores = scores.masked_fill(~mask4, float("-inf"))
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = torch.where(mask4, probs, torch.zeros_like(probs))
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bksd->bkgd", probs, v.float())
    return out.reshape(b, h, d).to(q.dtype)
