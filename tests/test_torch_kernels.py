"""PyTorch port kernels vs the JAX package's.

On the CPU each port wrapper runs its plain PyTorch version; it is held
against the JAX Pallas kernel run in interpret mode and against JAX's
plain reference, on the same inputs made with numpy from a seed. The
tolerances are those of tests/test_kernels.py: attention f32 1e-4, norm
f32 1e-5, bf16 2e-2, by ``rel_err``. Flash attention's cases are in
tests/test_torch_flash.py, the CUDA kernels' in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro_torch.kernels import decode_attention, launch_counts, reset_launch_counts, rmsnorm

from torch_port_helpers import attn_tol, both, norm_tol, normal, rel_err, to_np

# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def _decode_case(seed, b, h, kvh, s, d, lengths, dtype, window=None):
    rng = np.random.default_rng(seed)
    jq, tq = both(normal(rng, (b, h, d)), dtype)
    jk, tk = both(normal(rng, (b, kvh, s, d)), dtype)
    jv, tv = both(normal(rng, (b, kvh, s, d)), dtype)
    lens = np.asarray(lengths, np.int32)
    out = to_np(decode_attention(tq, tk, tv, torch.from_numpy(lens), window=window))
    interp = jax_decode(jq, jk, jv, jnp.asarray(lens), window=window, impl="interpret",
                        block_k=16)
    ref = jax_decode(jq, jk, jv, jnp.asarray(lens), window=window, impl="ref")
    return out, interp, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("kvh,s", [(1, 32), (2, 64)])
def test_decode_groups(group, kvh, s, dtype):
    out, interp, ref = _decode_case(group * 10 + s, 2, group * kvh, kvh, s, 16,
                                    [s // 2, s - 1], dtype)
    assert rel_err(out, interp) < attn_tol(dtype)
    assert rel_err(out, ref) < attn_tol(dtype)


@pytest.mark.parametrize("lengths,window", [([40, 63], 16), ([70, 5], None), ([70, 5], 16),
                                            ([0, 33], None)])
def test_decode_lengths_and_window(lengths, window):
    """Windowed lengths, a length above S (counts as S) and an empty row."""
    out, interp, ref = _decode_case(1, 2, 4, 2, 64, 16, lengths, "float32", window=window)
    assert rel_err(out, interp) < 1e-4
    assert rel_err(out, ref) < 1e-4


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0.0, 1.0])
@pytest.mark.parametrize("shape", [(3, 5, 48), (7, 40), (13, 33), (4, 32)])
def test_rmsnorm(shape, offset, dtype):
    rng = np.random.default_rng(shape[-1])
    jx, tx = both(normal(rng, shape), dtype)
    jw, tw = both(normal(rng, (shape[-1],), 0.1), dtype)
    out = to_np(rmsnorm(tx, tw, scale_offset=offset))
    interp = rmsnorm_pallas(jx, jw, scale_offset=offset, block_rows=4, interpret=True)
    ref = jax_rmsnorm(jx, jw, scale_offset=offset, impl="ref")
    assert rel_err(out, interp) < norm_tol(dtype)
    assert rel_err(out, ref) < norm_tol(dtype)


def test_cpu_path_launches_nothing():
    reset_launch_counts()
    x = torch.ones(2, 8)
    rmsnorm(x, torch.zeros(8))
    assert launch_counts() == {"rmsnorm": 0, "decode_attention": 0, "flash_attention": 0,
                               "rglru_scan": 0, "wkv6": 0}
