"""KV cache: definitions, update and decode attention.

The cache is updated in place (``update_cache``) rather than rebuilt by
the one-hot blend of ``repro.models.kvcache.update_cache``; the result
is the same, including the case that blend handles implicitly: a write
at a position >= max_len (an idle serving slot keeps advancing) changes
nothing. The windowed ring-buffer cache (griffin) is not ported yet.
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


def decode_attention_step(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    cache_l: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, 1, D) normed input
    lengths: torch.Tensor,               # (B,) int32
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GQA attention for one new token against the cache (updated in place)."""
    pos = lengths[:, None]
    q = rope(project_heads(x, p["wq"]), pos, cfg.rope_theta)         # (B, 1, H, hd)
    k = rope(project_heads(x, p["wk"]), pos, cfg.rope_theta)
    v = project_heads(x, p["wv"])

    ck, cv = update_cache(cache_l["k"], cache_l["v"], k, v, lengths)
    out = decode_attention(
        q[:, 0].contiguous(),                                         # (B, H, hd)
        ck, cv, (lengths + 1).to(torch.int32),
    )                                                                 # (B, H, hd)
    out = merge_heads(out[:, None], p["wo"])                          # (B, 1, D)
    return out, {"k": ck, "v": cv}
