"""Shared model layers: parameter declarations and the primitive blocks.

Parameters are declared as ``ParamDef`` trees (dicts and lists of
``ParamDef``); ``init_params`` materializes one into the same tree of
tensors, drawn from an explicit ``torch.Generator`` on the target
device. Layouts follow ``repro.models.layers`` (e.g. ``wq`` is
(d_model, heads, head_dim)), so a JAX parameter tree loads as it is
(``convert.py``).

The JAX package's logical-axis sharding (``shard``, the axis rules and
mesh context) is not ported: on one card it is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import flash_attention, rmsnorm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# ParamDef system
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | small_normal
    scale: float = 0.02
    dtype: Optional[str] = None  # None -> config dtype

    def initialize(self, gen: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
        dtype = torch_dtype(self.dtype or cfg.dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=gen.device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=gen.device)
        scale = self.scale if self.init == "normal" else self.scale * 0.1
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32, device=gen.device)
        return (x * scale).to(dtype)


def _traverse(tree: Any, fn: Callable[[ParamDef, Tuple], Any], path: Tuple = ()) -> Any:
    if isinstance(tree, ParamDef):
        return fn(tree, path)
    if isinstance(tree, dict):
        return {k: _traverse(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_traverse(v, fn, path + (i,)) for i, v in enumerate(tree))
    raise TypeError(f"unexpected node {type(tree)} at {path}")


def init_params(defs: Any, gen: torch.Generator, cfg: ModelConfig) -> Any:
    """Materialize a ParamDef tree into tensors on ``gen.device``.

    Tensors are drawn from ``gen`` in the tree's (fixed) traversal order,
    so one seed gives one set of weights. The numbers differ from JAX's
    for the same seed; tests that compare the two load JAX's weights."""
    return _traverse(defs, lambda d, path: d.initialize(gen, cfg))


def param_count(defs: Any) -> int:
    total = 0

    def one(d: ParamDef, path: Tuple) -> int:
        nonlocal total
        n = 1
        for s in d.shape:
            n *= s
        total += n
        return 0

    _traverse(defs, one)
    return total


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, offset: float = 0.0) -> torch.Tensor:
    return rmsnorm(x, w, eps=eps, scale_offset=offset)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D), positions: (B, S)."""
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    angles = positions[..., None].float() * freqs                     # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, scale_by_dim: bool = False) -> torch.Tensor:
    x = table[tokens]
    if scale_by_dim:
        # the scale is rounded to the table's dtype first, as in JAX
        x = x * torch.tensor(table.shape[-1] ** 0.5, dtype=x.dtype, device=x.device)
    return x


def unembed(x: torch.Tensor, table: torch.Tensor, valid: Optional[int] = None) -> torch.Tensor:
    """x: (B, S, D), table: (Vpad, D) -> logits (B, S, Vpad); rows beyond
    ``valid`` (vocab padding) are masked to -1e9 so softmax/argmax/CE
    ignore them."""
    logits = x @ table.t()
    if valid is not None and valid < table.shape[0]:
        logits[..., valid:] = -1e9
    return logits


# ---------------------------------------------------------------------------
# Attention (GQA) + MLP blocks
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, kvh, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamDef((d, cfg.n_heads, hd), ("embed_w", "heads", "head_dim")),
        "wk": ParamDef((d, kvh, hd), ("embed_w", "kv_heads", "head_dim")),
        "wv": ParamDef((d, kvh, hd), ("embed_w", "kv_heads", "head_dim")),
        "wo": ParamDef((cfg.n_heads, hd, d), ("heads", "head_dim", "embed_w")),
    }


def mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("embed_w", "ff")),
        "w_up": ParamDef((d, f), ("embed_w", "ff")),
        "w_down": ParamDef((f, d), ("ff", "embed_w")),
    }


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): (B, S, D) x (D, H, K) -> (B, S, H, K)."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def merge_heads(x: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"): (B, S, H, K) x (H, K, D) -> (B, S, D)."""
    return x.flatten(-2) @ wo.flatten(0, 1)


def apply_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return project_heads(x, p["wq"]), project_heads(x, p["wk"]), project_heads(x, p["wv"])


def heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> contiguous (B, H, S, D), the kernels' layout."""
    return x.transpose(1, 2).contiguous()


def attention_block(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, S, D)
    positions: torch.Tensor,             # (B, S)
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal GQA self-attention with RoPE through the flash kernel;
    ``window`` limits each query to the last ``window`` keys (local
    attention)."""
    q, k, v = apply_qkv(p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = flash_attention(heads_first(q), heads_first(k), heads_first(v),
                          causal=True, window=window).transpose(1, 2)     # (B, S, H, hd)
    return merge_heads(out, p["wo"])


def mlp_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Gated MLP of the dense family: GeGLU (tanh GELU) or SwiGLU."""
    if cfg.activation == "geglu":
        gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    elif cfg.activation == "swiglu":
        gate = F.silu(x @ p["w_gate"])
    else:
        raise NotImplementedError(f"activation {cfg.activation!r} is not ported yet")
    return (gate * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(
    logits: torch.Tensor,          # (B, S, V)
    labels: torch.Tensor,          # (B, S) int
    mask: Optional[torch.Tensor] = None,   # (B, S) 1=count
) -> torch.Tensor:
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
