"""Public RWKV-6 WKV op.

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``csrc/wkv6.cu``) or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._build import check, check_inputs, library, stream_of
from .ref import wkv6_ref

launches = 0   # kernel launches since the last reset_launch_counts()

MAX_K = 64     # the kernel keeps a column of K state values in registers


def _check(r, k, v, lw, u, state0) -> None:
    """r, k and v share one dtype (f32 or bf16); lw, u and state0 are f32.
    All on the current CUDA device, contiguous and without autograd."""
    check_inputs("wkv6", r, k, v)
    check_inputs("wkv6", lw, u, state0)
    if lw.dtype != torch.float32:
        raise TypeError(f"wkv6: lw, u and state0 must be float32, got {lw.dtype}")
    if lw.device != r.device:
        raise ValueError(f"wkv6: operands on {lw.device} and {r.device}")
    if r.dim() != 4:
        raise ValueError(f"wkv6: r of shape {tuple(r.shape)}; want (B, H, S, K)")
    b, h, s, kd = r.shape
    vd = v.shape[-1]
    want = {"k": (k, (b, h, s, kd)), "v": (v, (b, h, s, vd)), "lw": (lw, (b, h, s, kd)),
            "u": (u, (h, kd)), "state0": (state0, (b, h, kd, vd))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"wkv6: {name} of shape {tuple(t.shape)} != {shape}")
    if not 0 < kd <= MAX_K:
        raise ValueError(f"wkv6: K = {kd}; the CUDA kernel takes 1 <= K <= {MAX_K}")


def wkv6(
    r: torch.Tensor,       # (B, H, S, K)
    k: torch.Tensor,       # (B, H, S, K)
    v: torch.Tensor,       # (B, H, S, V)
    lw: torch.Tensor,      # (B, H, S, K) log decay, <= 0
    u: torch.Tensor,       # (H, K) bonus
    state0: torch.Tensor,  # (B, H, K, V)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every out_t (B, H, S, V) in v's dtype and the last state (B, H, K, V)
    in state0's of the RWKV-6 recurrence (``ref.py``)."""
    if v.device.type == "cpu":
        return wkv6_ref(r, k, v, lw, u, state0)
    _check(r, k, v, lw, u, state0)
    b, h, s, kd = r.shape
    vd = v.shape[-1]
    out = torch.empty_like(v)
    state = torch.empty_like(state0)
    if b * h * vd == 0:
        return out, state
    err = library().wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        state0.data_ptr(), out.data_ptr(), state.data_ptr(), b, h, s, kd, vd,
        int(v.dtype == torch.bfloat16), stream_of(v))
    check(err, "wkv6")
    global launches
    launches += 1
    return out, state
