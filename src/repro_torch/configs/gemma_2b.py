"""Gemma-2B: GeGLU, head_dim=256, MQA. [arXiv:2403.08295; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,               # MQA
    head_dim=256,
    d_ff=16_384,
    vocab_size=256_000,
    activation="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    norm_offset=1.0,
    embed_scale=True,
    grad_accum=8,               # 256k-vocab logits need microbatching
    sharding="dp_tp",
))
