"""Dense decoder-only transformer LM (gemma / llama / yi / phi4).

Pre-norm blocks, GQA attention with RoPE, SwiGLU/GeGLU MLPs, optional
tied embeddings. Layers are a Python list (the JAX package's scanned,
stacked layer axis is unstacked on loading, ``convert.py``). The MoE and
VLM branches of the JAX module are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import flash_attention
from .kvcache import attn_cache_defs, decode_attention_step
from .layers import (
    ParamDef,
    apply_qkv,
    attention_block,
    attn_defs,
    cross_entropy,
    embed_tokens,
    heads_first,
    merge_heads,
    mlp_block,
    mlp_defs,
    rms_norm,
    rope,
    unembed,
)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.norm_type != "rmsnorm":
        raise NotImplementedError(
            f"family {cfg.family!r} with {cfg.norm_type} is not ported to PyTorch yet "
            "(dense with rmsnorm only)")


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------


def norm_def(cfg: ModelConfig) -> Dict[str, ParamDef]:
    init = "zeros" if cfg.norm_offset else "ones"
    return {"w": ParamDef((cfg.d_model,), (None,), init=init)}


def apply_norm(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, p["w"], eps=cfg.norm_eps, offset=cfg.norm_offset)


def layer_defs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_family(cfg)
    return {
        "ln1": norm_def(cfg),
        "attn": attn_defs(cfg),
        "ln2": norm_def(cfg),
        "ffn": mlp_defs(cfg),
    }


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_padded, cfg.d_model), ("vocab", "embed_w")),
        "final_norm": norm_def(cfg),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.vocab_padded, cfg.d_model), ("vocab", "embed_w"))
    defs["layers"] = [layer_defs(cfg) for _ in range(cfg.n_layers)]
    return defs


def _table(cfg: ModelConfig, params: Dict[str, Any]) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = x + attention_block(cfg, p["attn"], apply_norm(cfg, p["ln1"], x), positions)
    return x + mlp_block(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x))


def backbone(cfg: ModelConfig, params: Dict[str, Any], x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """Run the decoder stack on embedded inputs x (B, S, D)."""
    for lp in params["layers"]:
        x = _block(cfg, lp, x, positions)
    return apply_norm(cfg, params["final_norm"], x)


def embed_inputs(cfg: ModelConfig, params: Dict[str, Any],
                 batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding; returns (x, positions)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, scale_by_dim=cfg.embed_scale)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions[None].expand(x.shape[:2])


def forward(cfg: ModelConfig, params: Dict[str, Any], batch: Dict[str, torch.Tensor], *,
            last_only: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward. Returns (logits, aux); aux is empty for the
    dense family (the JAX package fills it for MoE). ``last_only``
    computes the logits of the final position only."""
    x, positions = embed_inputs(cfg, params, batch)
    x = backbone(cfg, params, x, positions)
    if last_only:
        x = x[:, -1:]
    return unembed(x, _table(cfg, params), valid=cfg.vocab_size), {}


def loss_fn(cfg: ModelConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, _ = forward(cfg, params, batch)
    loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"ce_loss": loss, "loss": loss}


# ---------------------------------------------------------------------------
# Decode (KV cache)
# ---------------------------------------------------------------------------


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    _check_family(cfg)
    return {"layers": [attn_cache_defs(cfg, batch, max_len) for _ in range(cfg.n_layers)]}


def _decode_block(cfg: ModelConfig, p: Dict[str, Any], cache_l: Dict[str, torch.Tensor],
                  x: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer of single-token decode. x: (B, 1, D)."""
    y = apply_norm(cfg, p["ln1"], x)
    attn_out, cache_l = decode_attention_step(cfg, p["attn"], cache_l, y, lengths)
    x = x + attn_out
    return x + mlp_block(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x)), cache_l


def prefill(cfg: ModelConfig, params: Dict[str, Any], cache: Dict[str, Any],
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]:
    """Run the prompt through the stack while filling the KV cache.

    Returns (last-position logits (B,1,V), cache, lengths (B,)). Slots
    [0, P) of every layer's cache are overwritten in place; RoPE
    positions start at 0."""
    x, positions = embed_inputs(cfg, params, batch)
    P = x.shape[1]
    for lp, cl in zip(params["layers"], cache["layers"]):
        y = apply_norm(cfg, lp["ln1"], x)
        q, k, v = apply_qkv(lp["attn"], y)
        q = heads_first(rope(q, positions, cfg.rope_theta))
        k = heads_first(rope(k, positions, cfg.rope_theta))
        v = heads_first(v)
        cl["k"][:, :, :P] = k
        cl["v"][:, :, :P] = v
        att = flash_attention(q, k, v, causal=True).transpose(1, 2)
        x = x + merge_heads(att, lp["attn"]["wo"])
        x = x + mlp_block(cfg, lp["ffn"], apply_norm(cfg, lp["ln2"], x))
    x = apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = unembed(x, _table(cfg, params), valid=cfg.vocab_size)
    lengths = torch.full((x.shape[0],), P, dtype=torch.int32, device=x.device)
    return logits, cache, lengths


def decode_step(cfg: ModelConfig, params: Dict[str, Any], cache: Dict[str, Any],
                tokens: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (B, 1) int; lengths: (B,) int32 current cache fill. Returns
    (logits (B, 1, V), cache); the cache is updated in place."""
    _check_family(cfg)
    x = embed_tokens(params["embed"], tokens, scale_by_dim=cfg.embed_scale)
    new_layers = []
    for lp, cl in zip(params["layers"], cache["layers"]):
        x, cl = _decode_block(cfg, lp, cl, x, lengths)
        new_layers.append(cl)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(x, _table(cfg, params), valid=cfg.vocab_size)
    return logits, {"layers": new_layers}
