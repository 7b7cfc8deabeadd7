"""Fused RMSNorm: CUDA kernel, plain PyTorch version, wrapper."""
