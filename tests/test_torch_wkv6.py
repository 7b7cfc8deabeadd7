"""PyTorch port wkv6 vs the JAX package's, on the CPU.

On CPU tensors the port's wrapper runs its plain PyTorch loop; it is held
against JAX's plain reference, its chunked XLA form and the Pallas kernel
in interpret mode, on the same inputs made with numpy from a seed. The
tolerances are those of tests/test_kernels.py's TestWkv6: 1e-3 on out and
on the state by ``rel_err`` (the chunked forms sum in another order), 1e-4
for a sequence split over two calls; bf16 r/k/v at 3e-2. The CUDA kernel's
own comparisons are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro_torch.kernels import launch_counts, reset_launch_counts, wkv6
from repro_torch.kernels.wkv6.ref import wkv6_ref

from torch_port_helpers import both, normal, rel_err, to_np

CHUNK = 16


def _inputs(seed, b, h, s, kd, dtype="float32", lw_const=None):
    """r, k, v in ``dtype``; lw, u, state0 in f32, as the model passes them.
    Each as a (JAX, torch) pair."""
    rng = np.random.default_rng(seed)
    r, k, v = (both(normal(rng, (b, h, s, kd), 0.5), dtype) for _ in range(3))
    lw = (np.full((b, h, s, kd), lw_const, np.float32) if lw_const is not None
          else -rng.uniform(0.01, 4.0, (b, h, s, kd)).astype(np.float32))
    lw = both(lw, "float32")
    u = both(normal(rng, (h, kd), 0.3), "float32")
    s0 = both(normal(rng, (b, h, kd, kd), 0.1), "float32")
    return r, k, v, lw, u, s0


def _split(pairs):
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("impl", ["ref", "xla", "interpret"])
@pytest.mark.parametrize("kd", [8, 16])
@pytest.mark.parametrize("s", [1, 16, 48, 64])
@pytest.mark.parametrize("h", [2, 4])
@pytest.mark.parametrize("b", [1, 2])
def test_wkv6_matches_jax(b, h, s, kd, impl):
    jx, tx = _split(_inputs(7 * s + h + kd, b, h, s, kd))
    assert s % min(CHUNK, s) == 0          # the Pallas kernel asserts it
    out, state = wkv6(*tx)
    assert out.dtype == torch.float32 and state.dtype == torch.float32
    assert tuple(out.shape) == (b, h, s, kd) and tuple(state.shape) == (b, h, kd, kd)
    jout, jstate = jax_wkv6(*jx, impl=impl, chunk=CHUNK)
    assert rel_err(to_np(out), jout) < 1e-3
    assert rel_err(to_np(state), jstate) < 1e-3


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_wkv6_extreme_decay_stays_finite(impl):
    """lw = -50 everywhere: exp(lw) underflows towards 0 but nothing
    overflows; the port equals the JAX forms."""
    jx, tx = _split(_inputs(0, 1, 1, 32, 8, lw_const=-50.0))
    out, state = wkv6(*tx)
    assert bool(torch.isfinite(out).all() and torch.isfinite(state).all())
    jout, jstate = jax_wkv6(*jx, impl=impl, chunk=CHUNK)
    assert rel_err(to_np(out), jout) < 1e-3
    assert rel_err(to_np(state), jstate) < 1e-3


@pytest.mark.parametrize("cut", [1, 16, 31])
def test_wkv6_split_sequence_equals_one_call(cut):
    """The state carries: two calls, the second from the first's state,
    give one call's out and state (and JAX's, from one call)."""
    jx, (r, k, v, lw, u, s0) = _split(_inputs(9, 1, 2, 32, 8))
    o_full, s_full = wkv6(r, k, v, lw, u, s0)
    o1, s1 = wkv6(r[:, :, :cut], k[:, :, :cut], v[:, :, :cut], lw[:, :, :cut], u, s0)
    o2, s2 = wkv6(r[:, :, cut:], k[:, :, cut:], v[:, :, cut:], lw[:, :, cut:], u, s1)
    assert rel_err(to_np(torch.cat([o1, o2], 2)), to_np(o_full)) < 1e-4
    assert rel_err(to_np(s2), to_np(s_full)) < 1e-4
    jout, jstate = jax_wkv6(*jx, impl="xla", chunk=8)
    assert rel_err(to_np(o_full), jout) < 1e-3 and rel_err(to_np(s_full), jstate) < 1e-3


@pytest.mark.parametrize("impl", ["ref", "xla", "interpret"])
@pytest.mark.parametrize("s", [16, 64])
def test_wkv6_bf16_rkv_with_f32_state(s, impl):
    """The model's mix of dtypes: r, k, v in bf16, lw, u, state in f32;
    out comes back in bf16 and the state in f32."""
    jx, tx = _split(_inputs(s, 2, 2, s, 16, dtype="bfloat16"))
    out, state = wkv6(*tx)
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    jout, jstate = jax_wkv6(*jx, impl=impl, chunk=CHUNK)
    assert jout.dtype == jnp.bfloat16 and jstate.dtype == jnp.float32
    assert rel_err(to_np(out), np.asarray(jout, np.float32)) < 3e-2
    assert rel_err(to_np(state), jstate) < 3e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_wrapper_on_cpu_is_the_plain_version(dtype):
    """A CPU tensor takes ref.py, exactly, and launches no kernel."""
    _, tx = _split(_inputs(3, 2, 2, 20, 16, dtype=dtype))
    reset_launch_counts()
    out, state = wkv6(*tx)
    ref_out, ref_state = wkv6_ref(*tx)
    assert torch.equal(out, ref_out) and torch.equal(state, ref_state)
    assert launch_counts()["wkv6"] == 0


def test_wkv6_empty_sequence_keeps_state0():
    _, (r, k, v, lw, u, s0) = _split(_inputs(5, 1, 2, 0, 8))
    out, state = wkv6(r, k, v, lw, u, s0)
    assert tuple(out.shape) == (1, 2, 0, 8)
    assert torch.equal(state, s0)
