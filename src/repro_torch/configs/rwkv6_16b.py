"""RWKV-6 'Finch' 1.6B: attention-free, data-dependent decay. [arXiv:2404.05892; unverified]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv6",
    n_layers=24,
    d_model=2048,
    n_heads=32,                 # d_model / rwkv_head_dim
    n_kv_heads=32,
    head_dim=64,
    rwkv_head_dim=64,
    d_ff=7168,
    vocab_size=65_536,
    activation="relu_sq",       # rwkv channel mix uses squared relu
    grad_accum=4,
    sharding="dp_tp",
))
