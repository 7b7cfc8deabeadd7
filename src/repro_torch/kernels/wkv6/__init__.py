"""RWKV-6 WKV recurrence: CUDA kernel, plain PyTorch version, wrapper."""
