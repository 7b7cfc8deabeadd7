"""Shared helpers of the PyTorch port's parity tests (not a test module)."""

import numpy as np
import jax.numpy as jnp
import torch

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rel_err(a, b):
    """tests/test_kernels.py's error measure: max abs error over max |b|."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def attn_tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-4


def norm_tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-5


def both(x, dtype):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def to_np(t):
    return t.detach().cpu().float().numpy()


def jax_tree_to_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)
