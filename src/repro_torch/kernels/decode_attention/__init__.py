"""Decode attention over a KV cache: CUDA kernel, plain PyTorch version, wrapper."""
