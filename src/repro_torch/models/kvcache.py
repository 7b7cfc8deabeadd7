"""KV cache: definitions, update and decode attention.

The cache is updated in place (``update_cache``) rather than rebuilt by
the one-hot blend of ``repro.models.kvcache.update_cache``; the result
is the same, including the case that blend handles implicitly: a write
at a position >= max_len (an idle serving slot keeps advancing) changes
nothing. The windowed ring-buffer cache of local attention (griffin)
reuses the same update at slot ``lengths % window``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import decode_attention
from .layers import ParamDef, merge_heads, project_heads, rope


def attn_cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, ParamDef]:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    logical = ("batch", "cache_kv_heads", "cache_seq", None)
    return {
        "k": ParamDef(shape, logical, init="zeros"),
        "v": ParamDef(shape, logical, init="zeros"),
    }


def update_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one token per sequence at position lengths[b], in place.

    cache: (B, KV, S, hd); new: (B, 1, KV, hd); lengths: (B,). A sequence
    whose position lies outside [0, S) is left as it is (JAX's one-hot of
    such a position is all zeros). Out-of-range rows rewrite the value
    they already hold at a clamped index, so no host synchronisation is
    needed to find them. Returns the (same) cache tensors."""
    S = cache_k.shape[2]
    pos = lengths.long()
    inside = ((pos >= 0) & (pos < S))[:, None, None]
    idx = pos.clamp(0, S - 1)
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        old = cache[rows, :, idx]                                    # (B, KV, hd)
        cache[rows, :, idx] = torch.where(inside, new[:, 0].to(cache.dtype), old)
    return cache_k, cache_v


def _attend_one_token(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    cache_l: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, 1, D) normed input
    lengths: torch.Tensor,               # (B,) int32 absolute position of the token
    slots: torch.Tensor,                 # (B,) cache row the token's k/v go to
    valid: torch.Tensor,                 # (B,) cache rows [0, valid) attended
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    pos = lengths[:, None]
    q = rope(project_heads(x, p["wq"]), pos, cfg.rope_theta)         # (B, 1, H, hd)
    k = rope(project_heads(x, p["wk"]), pos, cfg.rope_theta)
    v = project_heads(x, p["wv"])

    ck, cv = update_cache(cache_l["k"], cache_l["v"], k, v, slots)
    out = decode_attention(q[:, 0].contiguous(), ck, cv, valid.to(torch.int32))   # (B, H, hd)
    out = merge_heads(out[:, None], p["wo"])                          # (B, 1, D)
    return out, {"k": ck, "v": cv}


def decode_attention_step(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    cache_l: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, 1, D) normed input
    lengths: torch.Tensor,               # (B,) int32
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GQA attention for one new token against the cache (updated in place)."""
    return _attend_one_token(cfg, p, cache_l, x, lengths, lengths, lengths + 1)


# ---------------------------------------------------------------------------
# Windowed (ring-buffer) cache for local attention (griffin)
# ---------------------------------------------------------------------------


def ring_decode_attention_step(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    cache_l: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, 1, D) normed input
    lengths: torch.Tensor,               # (B,) int32
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Local attention with a fixed ``window``-slot ring buffer (updated
    in place).

    Keys are roped at their *absolute* position before storage; attention
    over a set of (k, v) is permutation-invariant, so slot order never
    matters and the buffer stays O(window)."""
    window = cache_l["k"].shape[2]
    return _attend_one_token(cfg, p, cache_l, x, lengths, lengths % window,
                             torch.clamp_max(lengths + 1, window))
