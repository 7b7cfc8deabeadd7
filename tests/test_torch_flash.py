"""PyTorch port flash attention vs the JAX package's, on the CPU.

The port's wrapper runs its plain PyTorch version on CPU tensors; it is
held against the JAX Pallas kernel in interpret mode and JAX's plain
reference, on the same inputs made with numpy from a seed. Tolerances
are those of tests/test_kernels.py: f32 1e-4, bf16 2e-2, by ``rel_err``.
The CUDA kernel's own comparisons are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels import flash_attention

from torch_port_helpers import attn_tol, both, normal, rel_err, to_np


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _flash_case(seed, b, h, kvh, sq, skv, d, dtype, **kw):
    rng = np.random.default_rng(seed)
    jq, tq = both(normal(rng, (b, h, sq, d)), dtype)
    jk, tk = both(normal(rng, (b, kvh, skv, d)), dtype)
    jv, tv = both(normal(rng, (b, kvh, skv, d)), dtype)
    out = to_np(flash_attention(tq, tk, tv, **kw))
    interp = jax_flash(jq, jk, jv, impl="interpret", block_q=16, block_k=16, **kw)
    ref = jax_flash(jq, jk, jv, impl="ref", **kw)
    return out, interp, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,kvh", [(1, 2), (2, 1), (4, 1)])
def test_flash_gqa_groups(group, kvh, dtype):
    out, interp, ref = _flash_case(group * 10 + kvh, 2, group * kvh, kvh, 32, 32, 16, dtype,
                                   causal=True)
    assert rel_err(out, interp) < attn_tol(dtype)
    assert rel_err(out, ref) < attn_tol(dtype)


@pytest.mark.parametrize("s", [33, 40, 100])
@pytest.mark.parametrize("causal,dtype", [(True, "float32"), (False, "float32"),
                                          (True, "bfloat16")])
def test_flash_odd_lengths(s, causal, dtype):
    out, interp, ref = _flash_case(s, 1, 2, 1, s, s, 16, dtype, causal=causal)
    assert rel_err(out, interp) < attn_tol(dtype)
    assert rel_err(out, ref) < attn_tol(dtype)


@pytest.mark.parametrize("kwargs", [{"q_offset": 33}, {"window": 24, "q_offset": 33},
                                    {"window": 8}])
def test_flash_window_and_offset(kwargs):
    sq = 50 if kwargs.get("q_offset") is None else 17
    out, interp, ref = _flash_case(7, 1, 2, 2, sq, 50, 16, "float32", causal=True, **kwargs)
    assert rel_err(out, interp) < 1e-4
    assert rel_err(out, ref) < 1e-4


def test_flash_kv_only_padding():
    """kv rows past Skv must not leak into the softmax when Sq != Skv."""
    out, interp, ref = _flash_case(11, 2, 2, 2, 32, 45, 16, "float32", causal=False)
    assert rel_err(out, interp) < 1e-4
    assert rel_err(out, ref) < 1e-4


def test_flash_fully_masked_row_is_zero():
    """A row with no visible key (window shorter than the offset gap) gives 0."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(normal(rng, s)) for s in [(1, 1, 4, 16), (1, 1, 8, 16),
                                                          (1, 1, 8, 16)])
    out = flash_attention(q, k, v, causal=True, q_offset=-3)
    assert torch.isfinite(out).all()
    assert torch.all(out[0, 0, :3] == 0)


