"""RWKV-6 "Finch": attention-free LM with data-dependent decay.

Per layer: a *time-mixing* block (token shift -> r/k/v/gate/decay
projections -> multi-head WKV linear-attention recurrence with per-step
data-dependent decay, through the ``wkv6`` kernel -> group norm ->
output projection) and a *channel-mixing* block (token shift ->
squared-ReLU MLP with a sigmoid gate). Decode keeps an O(1) state per
layer: the last token of each block (``tmix_x``, ``cmix_x``) and the
per-head K x K WKV matrix in f32.

The counterpart of ``repro.models.rwkv6``, with the same simplification:
the data-dependent LoRA modulates the decay only. Layers and their states
are Python lists; the JAX package's stacked (``scan_layers``) trees are
unstacked on loading (``convert.py``). The JAX package's remat
(``jax.checkpoint``) is training-only and not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import wkv6
from .layers import ParamDef, cross_entropy, embed_tokens, rms_norm, unembed

LORA_RANK = 32


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def layer_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    H, K = _heads(cfg)
    return {
        "ln1": {"w": ParamDef((d,), (None,), init="ones")},
        "tmix": {
            "mu_r": ParamDef((d,), (None,), init="zeros"),
            "mu_k": ParamDef((d,), (None,), init="zeros"),
            "mu_v": ParamDef((d,), (None,), init="zeros"),
            "mu_w": ParamDef((d,), (None,), init="zeros"),
            "mu_g": ParamDef((d,), (None,), init="zeros"),
            "wr": ParamDef((d, d), ("embed_w", "heads_flat")),
            "wk": ParamDef((d, d), ("embed_w", "heads_flat")),
            "wv": ParamDef((d, d), ("embed_w", "heads_flat")),
            "wg": ParamDef((d, d), ("embed_w", "heads_flat")),
            "w0": ParamDef((d,), (None,), init="zeros"),
            "w_lora_a": ParamDef((d, LORA_RANK), ("embed_w", None)),
            "w_lora_b": ParamDef((LORA_RANK, d), (None, None)),
            "u": ParamDef((H, K), (None, None), init="zeros"),
            "ln_x": ParamDef((d,), (None,), init="ones"),
            "wo": ParamDef((d, d), ("heads_flat", "embed_w")),
        },
        "ln2": {"w": ParamDef((d,), (None,), init="ones")},
        "cmix": {
            "mu_k": ParamDef((d,), (None,), init="zeros"),
            "mu_r": ParamDef((d,), (None,), init="zeros"),
            "wk": ParamDef((d, f), ("embed_w", "ff")),
            "wv": ParamDef((f, d), ("ff", "embed_w")),
            "wr": ParamDef((d, d), ("embed_w", None)),
        },
    }


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "embed": ParamDef((cfg.vocab_padded, cfg.d_model), ("vocab", "embed_w")),
        "final_norm": {"w": ParamDef((cfg.d_model,), (None,), init="ones")},
        "unembed": ParamDef((cfg.vocab_padded, cfg.d_model), ("vocab", "embed_w")),
        "layers": [layer_defs(cfg) for _ in range(cfg.n_layers)],
    }


# ---------------------------------------------------------------------------
# Time mixing and channel mixing
# ---------------------------------------------------------------------------


def _shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} with ``last`` filling position 0. x: (B,S,D)."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xx: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (xx - x) * mu


def _tmix_inputs(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 last_x: torch.Tensor):
    """r, k, v, log-decay (each (B,H,S,K), contiguous) and the gate g
    (B,S,D) of a sequence x (B,S,D). The log decay is formed in f32 from
    the LoRA clipped in x's dtype, then narrowed to x's dtype, as in the
    JAX function."""
    H, K = _heads(cfg)
    B, S, _ = x.shape
    xx = _shift(x, last_x)
    r = _mix(x, xx, p["mu_r"]) @ p["wr"]
    k = _mix(x, xx, p["mu_k"]) @ p["wk"]
    v = _mix(x, xx, p["mu_v"]) @ p["wv"]
    g = F.silu(_mix(x, xx, p["mu_g"]) @ p["wg"])
    lora = torch.tanh(_mix(x, xx, p["mu_w"]) @ p["w_lora_a"]) @ p["w_lora_b"]
    lw = -torch.exp(torch.clamp(p["w0"] + lora, -8.0, 6.0).float())   # log decay <= 0

    def to_heads(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(B, S, H, K).transpose(1, 2).contiguous()     # (B,H,S,K)

    return to_heads(r), to_heads(k), to_heads(v), to_heads(lw.to(x.dtype)), g


def _group_norm(x: torch.Tensor, w: torch.Tensor, H: int, eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm over the flattened head outputs, in f32 and
    scaled by w before narrowing to x's dtype. x: (B,S,D)."""
    B, S, d = x.shape
    xg = x.reshape(B, S, H, d // H).float()
    mean = xg.mean(-1, keepdim=True)
    var = ((xg - mean) ** 2).mean(-1, keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return (xg.reshape(B, S, d) * w).to(x.dtype)


def tmix_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               last_x: torch.Tensor, state0: torch.Tensor):
    """x: (B,S,D) normed; state0: (B,H,K,K) f32. Returns (out, new_last_x,
    new_state)."""
    H, _ = _heads(cfg)
    r, k, v, lw, g = _tmix_inputs(cfg, p, x, last_x)
    out, state = wkv6(r, k, v, lw.float(), p["u"].float(), state0)
    B, _, S, _ = out.shape
    out = out.transpose(1, 2).reshape(B, S, cfg.d_model)
    out = _group_norm(out, p["ln_x"], H) * g
    return out @ p["wo"], x[:, -1], state


def cmix_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               last_x: torch.Tensor):
    """The squared-ReLU channel mix with a sigmoid gate. Returns (out,
    new_last_x)."""
    xx = _shift(x, last_x)
    k = torch.square(F.relu(_mix(x, xx, p["mu_k"]) @ p["wk"]))
    r = torch.sigmoid(_mix(x, xx, p["mu_r"]) @ p["wr"])
    return r * (k @ p["wv"]), x[:, -1]


def _layer(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
           st: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """st: dict(tmix_x (B,D), cmix_x (B,D), wkv (B,H,K,K) f32)."""
    y, tlast, wkv_state = tmix_block(cfg, p["tmix"], rms_norm(x, p["ln1"]["w"], eps=cfg.norm_eps),
                                     st["tmix_x"], st["wkv"])
    x = x + y
    y, clast = cmix_block(cfg, p["cmix"], rms_norm(x, p["ln2"]["w"], eps=cfg.norm_eps),
                          st["cmix_x"])
    return x + y, {"tmix_x": tlast, "cmix_x": clast, "wkv": wkv_state}


# ---------------------------------------------------------------------------
# State, forward, loss, decode
# ---------------------------------------------------------------------------


def state_defs(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    """One state per layer; the WKV matrix is f32 whatever the model's dtype."""
    H, K = _heads(cfg)
    per = {
        "tmix_x": ParamDef((batch, cfg.d_model), ("batch", "state"), init="zeros"),
        "cmix_x": ParamDef((batch, cfg.d_model), ("batch", "state"), init="zeros"),
        "wkv": ParamDef((batch, H, K, K), ("batch", "heads", None, None), init="zeros",
                        dtype="float32"),
    }
    return {"layers": [per for _ in range(cfg.n_layers)]}


def _zero_state(cfg: ModelConfig, batch_size: int, dtype: torch.dtype,
                device: torch.device) -> Dict[str, torch.Tensor]:
    H, K = _heads(cfg)
    return {
        "tmix_x": torch.zeros((batch_size, cfg.d_model), dtype=dtype, device=device),
        "cmix_x": torch.zeros((batch_size, cfg.d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch_size, H, K, K), dtype=torch.float32, device=device),
    }


def forward(cfg: ModelConfig, params: Dict[str, Any], batch: Dict[str, torch.Tensor], *,
            last_only: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward from a zero state. Returns (logits, {});
    ``last_only`` computes the logits of the final position only."""
    x = embed_tokens(params["embed"], batch["tokens"])
    zero = _zero_state(cfg, x.shape[0], x.dtype, x.device)
    for lp in params["layers"]:
        x, _ = _layer(cfg, lp, x, zero)
    x = rms_norm(x, params["final_norm"]["w"], eps=cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return unembed(x, params["unembed"], valid=cfg.vocab_size), {}


def loss_fn(cfg: ModelConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, _ = forward(cfg, params, batch)
    loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"loss": loss, "ce_loss": loss}


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    return state_defs(cfg, batch)


def decode_step(cfg: ModelConfig, params: Dict[str, Any], cache: Dict[str, Any],
                tokens: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-token step through the same layer code with S = 1. tokens:
    (B, 1) int; ``lengths`` is unused (the state is recurrent). Returns
    (logits (B, 1, V), the new states)."""
    x = embed_tokens(params["embed"], tokens)       # (B, 1, D)
    new_states = []
    for lp, st in zip(params["layers"], cache["layers"]):
        x, st = _layer(cfg, lp, x, st)
        new_states.append(st)
    x = rms_norm(x, params["final_norm"]["w"], eps=cfg.norm_eps)
    return unembed(x, params["unembed"], valid=cfg.vocab_size), {"layers": new_states}
