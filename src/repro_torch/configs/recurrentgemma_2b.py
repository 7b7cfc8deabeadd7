"""RecurrentGemma-2B (Griffin): RG-LRU + local attention, 1:2. [arXiv:2402.19427; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="griffin",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,               # local attention is MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    activation="geglu",
    attn_every=3,               # (recurrent, recurrent, local_attn) repeating
    local_window=2048,
    conv_width=4,
    tie_embeddings=True,
    norm_offset=1.0,
    embed_scale=True,
    grad_accum=8,
    sharding="dp_tp",
))
