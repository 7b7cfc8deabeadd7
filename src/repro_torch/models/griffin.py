"""RecurrentGemma (Griffin): RG-LRU recurrent blocks + local attention, 1:2.

Layer pattern repeats (recurrent, recurrent, local_attn) — cfg.attn_every
= 3. The recurrent block is Griffin's gated unit: two linear branches,
one through a short causal depthwise conv then the RG-LRU diagonal
recurrence (the ``rglru_scan`` kernel), one through a GeLU gate. Local
attention is sliding-window MQA with RoPE (the flash kernel's
``window``). Every layer is followed by a GeGLU MLP. Decode state is O(1)
per recurrent layer (conv tail + LRU state) and O(window) per attention
layer (ring-buffer KV cache, updated in place).

Layers are heterogeneous, so the stack is a list of per-layer trees with
different keys, as in ``repro.models.griffin``. The JAX package's remat
(``jax.checkpoint``) is training-only and not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import rglru_scan
from .kvcache import attn_cache_defs, ring_decode_attention_step
from .layers import (
    ParamDef,
    attention_block,
    attn_defs,
    cross_entropy,
    embed_tokens,
    mlp_block,
    mlp_defs,
    unembed,
)
from .transformer import apply_norm, norm_def

RGLRU_C = 8.0


def is_attn_layer(cfg: ModelConfig, i: int) -> bool:
    return cfg.attn_every > 0 and (i % cfg.attn_every) == (cfg.attn_every - 1)


def recurrent_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    w = cfg.conv_width
    return {
        "w_in_x": ParamDef((d, d), ("embed_w", "state")),       # recurrence branch
        "w_in_g": ParamDef((d, d), ("embed_w", "state")),       # gate branch
        "conv_w": ParamDef((w, d), (None, "state")),            # depthwise causal conv
        "conv_b": ParamDef((d,), ("state",), init="zeros"),
        "lru_input_gate": ParamDef((d, d), ("state", "state2")),
        "lru_rec_gate": ParamDef((d, d), ("state", "state2")),
        "lru_log_lambda": ParamDef((d,), (None,), init="normal", scale=0.5),
        "w_out": ParamDef((d, d), ("state", "embed_w")),
    }


def layer_defs(cfg: ModelConfig, i: int) -> Dict[str, Any]:
    temporal = (
        {"kind_attn": attn_defs(cfg)} if is_attn_layer(cfg, i)
        else {"kind_rec": recurrent_defs(cfg)}
    )
    return {
        "ln1": norm_def(cfg),
        "temporal": temporal,
        "ln2": norm_def(cfg),
        "ffn": mlp_defs(cfg),
    }


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "embed": ParamDef((cfg.vocab_padded, cfg.d_model), ("vocab", "embed_w")),
        "final_norm": norm_def(cfg),
        "layers": [layer_defs(cfg, i) for i in range(cfg.n_layers)],
    }


# ---------------------------------------------------------------------------
# RG-LRU + conv
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B,S,D), w: (W,D). ``tail``: (B,W-1,D)
    carries the last W-1 inputs for decode. Returns (y, new_tail)."""
    W = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)
    y = sum(xp[:, i : i + x.shape[1]] * w[i] for i in range(W))
    return y + b, xp[:, -(W - 1):]


def _rglru(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
           h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (y, h_final).

    The dtype steps are the JAX function's: the decay is formed in x's
    dtype and widened to f32, the input scale is computed in f32 and
    narrowed to x's dtype, and the scan takes log_a in x's dtype."""
    r = torch.sigmoid(x @ p["lru_rec_gate"])
    i = torch.sigmoid(x @ p["lru_input_gate"])
    log_a = (-RGLRU_C * F.softplus(p["lru_log_lambda"]) * r).float()
    gated = i * x
    scale = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)).to(x.dtype)
    return rglru_scan(log_a.to(x.dtype), scale * gated, h0)


def recurrent_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                    state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """state: dict(conv (B,W-1,D), h (B,D)). x normed (B,S,D)."""
    gate = F.gelu(x @ p["w_in_g"], approximate="tanh")
    u = x @ p["w_in_x"]
    u, conv_tail = _causal_conv(u, p["conv_w"], p["conv_b"], state["conv"])
    y, h_final = _rglru(cfg, p, u, state["h"])
    out = (y * gate) @ p["w_out"]
    return out, {"conv": conv_tail, "h": h_final}


def _zero_rec_state(cfg: ModelConfig, B: int, dtype: torch.dtype,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((B, cfg.conv_width - 1, cfg.d_model), dtype=dtype, device=device),
        "h": torch.zeros((B, cfg.d_model), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


def _layer_train(cfg: ModelConfig, i: int, p: Dict[str, Any], x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    y = apply_norm(cfg, p["ln1"], x)
    if is_attn_layer(cfg, i):
        t = attention_block(cfg, p["temporal"]["kind_attn"], y, positions,
                            window=cfg.local_window)
    else:
        t, _ = recurrent_block(cfg, p["temporal"]["kind_rec"], y,
                               _zero_rec_state(cfg, x.shape[0], x.dtype, x.device))
    x = x + t
    y = apply_norm(cfg, p["ln2"], x)
    return x + mlp_block(cfg, p["ffn"], y)


def forward(cfg: ModelConfig, params: Dict[str, Any], batch: Dict[str, torch.Tensor], *,
            last_only: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward. Returns (logits, {}); ``last_only`` computes
    the logits of the final position only."""
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, scale_by_dim=cfg.embed_scale)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None].expand(x.shape[:2])
    for i, lp in enumerate(params["layers"]):
        x = _layer_train(cfg, i, lp, x, positions)
    x = apply_norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    return unembed(x, params["embed"], valid=cfg.vocab_size), {}   # tied


def loss_fn(cfg: ModelConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, _ = forward(cfg, params, batch)
    loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"loss": loss, "ce_loss": loss}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    layers: List[Dict[str, Any]] = []
    window = min(cfg.local_window, max_len)
    for i in range(cfg.n_layers):
        if is_attn_layer(cfg, i):
            layers.append({"attn": attn_cache_defs(cfg, batch, window)})   # ring of window rows
        else:
            layers.append({
                "conv": ParamDef((batch, cfg.conv_width - 1, cfg.d_model),
                                 ("batch", None, "state"), init="zeros"),
                "h": ParamDef((batch, cfg.d_model), ("batch", "state"), init="zeros"),
            })
    return {"layers": layers}


def decode_step(cfg: ModelConfig, params: Dict[str, Any], cache: Dict[str, Any],
                tokens: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (B, 1) int; lengths: (B,) int32 tokens seen so far. Returns
    (logits (B, 1, V), cache): the ring buffers are updated in place, the
    recurrent states are new tensors."""
    x = embed_tokens(params["embed"], tokens, scale_by_dim=cfg.embed_scale)
    new_layers = []
    for i, (lp, cl) in enumerate(zip(params["layers"], cache["layers"])):
        y = apply_norm(cfg, lp["ln1"], x)
        if is_attn_layer(cfg, i):
            t, kv = ring_decode_attention_step(cfg, lp["temporal"]["kind_attn"], cl["attn"],
                                               y, lengths)
            new_layers.append({"attn": kv})
        else:
            t, st = recurrent_block(cfg, lp["temporal"]["kind_rec"], y, cl)
            new_layers.append(st)
        x = x + t
        y = apply_norm(cfg, lp["ln2"], x)
        x = x + mlp_block(cfg, lp["ffn"], y)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(x, params["embed"], valid=cfg.vocab_size)
    return logits, {"layers": new_layers}
