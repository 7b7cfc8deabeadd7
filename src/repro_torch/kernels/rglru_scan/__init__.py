"""RG-LRU linear recurrence: CUDA kernel, plain PyTorch version, wrapper."""
