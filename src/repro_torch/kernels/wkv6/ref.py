"""Plain PyTorch RWKV-6 WKV recurrence (a loop over the sequence).

Per (b, h), with a K x V state S:
    out_t = r_t @ (S_{t-1} + (u * k_t)^T v_t)
    S_t   = diag(exp(lw_t)) S_{t-1} + k_t^T v_t
where lw_t <= 0 is the data-dependent log decay and u the bonus of the
current token. All in f32 from state0; ``out`` is returned in v's dtype
and the last state in state0's, as the CUDA kernel and the JAX
reference do. Column v of S and of out uses column v of v only.
"""

from __future__ import annotations

from typing import Tuple

import torch


def wkv6_ref(
    r: torch.Tensor,       # (B, H, S, K)
    k: torch.Tensor,       # (B, H, S, K)
    v: torch.Tensor,       # (B, H, S, V)
    lw: torch.Tensor,      # (B, H, S, K) log decay, <= 0
    u: torch.Tensor,       # (H, K) bonus
    state0: torch.Tensor,  # (B, H, K, V)
) -> Tuple[torch.Tensor, torch.Tensor]:
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(lw.float())
    uf = u.float()[None, :, :, None]                            # (1, H, K, 1)
    S = state0.float()
    out = torch.empty_like(vf)
    for t in range(vf.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]        # (B, H, K, V)
        out[:, :, t] = (rf[:, :, t, :, None] * (S + uf * kv)).sum(-2)
        S = w[:, :, t, :, None] * S + kv
    return out.to(v.dtype), S.to(state0.dtype)
