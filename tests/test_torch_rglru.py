"""PyTorch port rglru_scan vs the JAX package's, on the CPU.

On CPU tensors the port's wrapper runs its plain PyTorch loop; it is held
against the JAX Pallas kernel in interpret mode and JAX's plain
reference, on the same inputs made with numpy from a seed. Tolerances
are those of tests/test_kernels.py's TestRglruScan: f32 1e-4, bf16 3e-2,
by ``rel_err``. The CUDA kernel's own comparisons are in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru
from repro_torch.kernels import rglru_scan

from torch_port_helpers import both, normal, rel_err, to_np


def rglru_tol(dtype):
    return 3e-2 if dtype == "bfloat16" else 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 32])
@pytest.mark.parametrize("s", [1, 16, 96])
@pytest.mark.parametrize("b", [1, 3])
def test_rglru_matches_jax(b, s, d, dtype):
    rng = np.random.default_rng(100 * b + s + d)
    ja, ta = both(-rng.uniform(0.01, 3.0, (b, s, d)).astype(np.float32), dtype)
    jx, tx = both(normal(rng, (b, s, d)), dtype)
    jh, th = both(normal(rng, (b, d)), dtype)
    hs, hlast = rglru_scan(ta, tx, th)
    assert hs.dtype == hlast.dtype == tx.dtype
    assert tuple(hs.shape) == (b, s, d) and tuple(hlast.shape) == (b, d)
    for impl in ("interpret", "ref"):
        jhs, jhlast = jax_rglru(ja, jx, jh, impl=impl)
        assert rel_err(to_np(hs), jhs) < rglru_tol(dtype), impl
        assert rel_err(to_np(hlast), jhlast) < rglru_tol(dtype), impl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_strong_decay_stable(dtype):
    """log_a = -30 with h0 = 100: no overflow or NaN, and the state is the
    input after one step (exp(-30) * 100 is below f32 resolution of 1)."""
    b, s, d = 1, 64, 16
    ja, ta = both(np.full((b, s, d), -30.0, np.float32), dtype)
    jx, tx = both(np.ones((b, s, d), np.float32), dtype)
    jh, th = both(np.full((b, d), 100.0, np.float32), dtype)
    hs, hlast = rglru_scan(ta, tx, th)
    assert bool(torch.isfinite(hs).all() and torch.isfinite(hlast).all())
    jhs, jhlast = jax_rglru(ja, jx, jh, impl="ref")
    assert rel_err(to_np(hs), jhs) < rglru_tol(dtype)
    np.testing.assert_allclose(to_np(hs), 1.0, rtol=1e-6)


def test_rglru_empty_sequence_keeps_h0():
    h0 = torch.randn(2, 8)
    hs, hlast = rglru_scan(torch.zeros(2, 0, 8), torch.zeros(2, 0, 8), h0)
    assert tuple(hs.shape) == (2, 0, 8)
    assert torch.equal(hlast, h0)
    jhs, jhlast = jax_rglru(jnp.zeros((2, 0, 8)), jnp.zeros((2, 0, 8)), jnp.asarray(h0.numpy()),
                            impl="ref")
    np.testing.assert_array_equal(hlast.numpy(), np.asarray(jhlast))
