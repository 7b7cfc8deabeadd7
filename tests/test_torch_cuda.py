"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerances are those of tests/test_kernels.py: attention f32 1e-4, norm
f32 1e-5, bf16 2e-2, rglru_scan f32 1e-4 and bf16 3e-2, wkv6 f32 1e-3 and
bf16 3e-2, by ``rel_err``.
TF32 is off for the plain versions.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    decode_attention,
    flash_attention,
    launch_counts,
    reset_launch_counts,
    rglru_scan,
    rmsnorm,
    wkv6,
)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.wkv6.ref import wkv6_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def attn_tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-4


def norm_tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-5


def normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def cuda():
    """The card, with TF32 off; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels compile and run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(cuda, dtype, *arrays):
    return [torch.from_numpy(a).to(cuda, DTYPES[dtype]) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offset", [((4, 2048), 1.0), ((512, 2048), 1.0),
                                          ((7, 40), 0.0), ((3, 5, 100), 1.0)])
def test_cuda_rmsnorm_matches_plain(cuda, shape, offset, dtype):
    rng = np.random.default_rng(0)
    x, w = _on(cuda, dtype, normal(rng, shape), normal(rng, shape[-1:], 0.1))
    reset_launch_counts()
    out = rmsnorm(x, w, scale_offset=offset)
    assert launch_counts()["rmsnorm"] == 1
    ref = rmsnorm_ref(x, w, scale_offset=offset)
    assert rel_err(out, ref) < norm_tol(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,s,d,lengths,window", [
    (4, 8, 1, 128, 256, [1, 17, 64, 128], None),
    (4, 8, 1, 4096, 256, [4000, 4095, 4093, 5000], None),
    (2, 4, 2, 64, 32, [40, 63], 16),
    (2, 16, 1, 100, 64, [0, 100], None),
    (3, 3, 1, 50, 16, [7, 50, 49], None),
    (4, 10, 1, 2048, 256, [1, 700, 2048, 2048], None),
    (4, 10, 1, 128, 256, [1, 37, 100, 128], None),
])
def test_cuda_decode_matches_plain(cuda, b, h, kvh, s, d, lengths, window, dtype):
    rng = np.random.default_rng(s)
    q, k, v = _on(cuda, dtype, normal(rng, (b, h, d)), normal(rng, (b, kvh, s, d)),
                  normal(rng, (b, kvh, s, d)))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, lens, window=window)
    ref = decode_attention_ref(q, k, v, lens, window=window)
    assert rel_err(out, ref) < attn_tol(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,sq,skv,d,kw", [
    (1, 8, 1, 1024, 1024, 256, {"causal": True}),
    (1, 8, 1, 1000, 1000, 256, {"causal": True}),
    (1, 8, 1, 200, 1024, 256, {"causal": True, "window": 300, "q_offset": 824}),
    (2, 4, 2, 33, 45, 64, {"causal": False}),
    (2, 4, 1, 100, 100, 128, {"causal": True, "window": 24}),
    (2, 4, 2, 33, 33, 16, {"causal": True}),
    (1, 4, 1, 70, 90, 16, {"causal": True, "window": 24, "q_offset": 20}),
])
def test_cuda_flash_matches_plain(cuda, b, h, kvh, sq, skv, d, kw, dtype):
    rng = np.random.default_rng(sq)
    q, k, v = _on(cuda, dtype, normal(rng, (b, h, sq, d)), normal(rng, (b, kvh, skv, d)),
                  normal(rng, (b, kvh, skv, d)))
    out = flash_attention(q, k, v, **kw)
    ref = attention_ref(q, k, v, **kw)
    assert rel_err(out, ref) < attn_tol(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d", [(4, 1, 2560), (2, 7, 100), (1, 256, 2560), (3, 256, 33)])
def test_cuda_rglru_matches_plain(cuda, b, s, d, dtype):
    rng = np.random.default_rng(s + d)
    log_a, x, h0 = _on(cuda, dtype, -rng.uniform(0.01, 3.0, (b, s, d)).astype(np.float32),
                       normal(rng, (b, s, d)), normal(rng, (b, d)))
    reset_launch_counts()
    hs, hlast = rglru_scan(log_a, x, h0)
    assert launch_counts()["rglru_scan"] == 1
    ref_hs, ref_hlast = rglru_scan_ref(log_a, x, h0)
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    assert hs.dtype == hlast.dtype == x.dtype
    assert rel_err(hs, ref_hs) < tol and rel_err(hlast, ref_hlast) < tol


@pytest.mark.gpu
def test_cuda_rglru_strong_decay_stays_finite(cuda):
    hs, hlast = rglru_scan(torch.full((2, 64, 2560), -30.0, device=cuda),
                           torch.ones(2, 64, 2560, device=cuda),
                           torch.full((2, 2560), 100.0, device=cuda))
    assert bool(torch.isfinite(hs).all()) and bool((hs == 1.0).all())
    assert bool((hlast == 1.0).all())


@pytest.mark.gpu
@torch.no_grad()
def test_cuda_reduced_griffin_decode_matches_forward(cuda):
    """The reduced recurrentgemma-2b on the card: every kernel of the path
    runs, and teacher-forced decode reproduces forward (rel_err < 2e-3)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    m = build_model(smoke_config("recurrentgemma-2b").with_(dtype="float32", local_window=4))
    p = m.init(0)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 512, (2, 10))
                            .astype(np.int32)).to(cuda)
    reset_launch_counts()
    full, _ = m.forward(p, {"tokens": toks})
    cache = m.init_cache(2, 12)
    dec = []
    for t in range(10):
        logits, cache = m.decode_step(p, cache, toks[:, t:t + 1],
                                      torch.full((2,), t, dtype=torch.int32, device=cuda))
        dec.append(logits[:, 0])
    assert launch_counts() == {"rmsnorm": 7 * 11, "flash_attention": 1,
                               "decode_attention": 10, "rglru_scan": 2 * 11, "wkv6": 0}
    assert rel_err(torch.stack(dec, 1), full) < 2e-3


def _wkv6_inputs(cuda, dtype, b, h, s, kd, lw_const=None, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = _on(cuda, dtype, *(normal(rng, (b, h, s, kd), 0.5) for _ in range(3)))
    lw = (np.full((b, h, s, kd), lw_const, np.float32) if lw_const is not None
          else -rng.uniform(0.01, 4.0, (b, h, s, kd)).astype(np.float32))
    lw, u, s0 = _on(cuda, "float32", lw, normal(rng, (h, kd), 0.3),
                    normal(rng, (b, h, kd, kd), 0.1))
    return r, k, v, lw, u, s0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,kd,lw_const", [
    (4, 32, 1, 64, None), (2, 4, 7, 16, None), (1, 32, 130, 64, None), (2, 3, 130, 40, None),
    (1, 2, 130, 64, -50.0),
])
def test_cuda_wkv6_matches_plain(cuda, b, h, s, kd, lw_const, dtype):
    args = _wkv6_inputs(cuda, dtype, b, h, s, kd, lw_const, seed=s + kd)
    reset_launch_counts()
    out, state = wkv6(*args)
    assert launch_counts()["wkv6"] == 1
    ref_out, ref_state = wkv6_ref(*args)
    tol = 3e-2 if dtype == "bfloat16" else 1e-3
    assert out.dtype == args[2].dtype and state.dtype == torch.float32
    assert bool(torch.isfinite(out).all() and torch.isfinite(state).all())
    assert rel_err(out, ref_out) < tol and rel_err(state, ref_state) < tol


@pytest.mark.gpu
def test_cuda_wkv6_refuses_a_bf16_state(cuda):
    r, k, v, lw, u, s0 = _wkv6_inputs(cuda, "bfloat16", 1, 2, 4, 16)
    with pytest.raises(TypeError, match="float32"):
        wkv6(r, k, v, lw.bfloat16(), u.bfloat16(), s0.bfloat16())


@pytest.mark.gpu
@torch.no_grad()
def test_cuda_reduced_rwkv6_decode_matches_forward(cuda):
    """The reduced rwkv6-1.6b on the card: wkv6 and rmsnorm run once per
    layer (and rmsnorm once more for the final norm) in forward and in
    every decode step, and decode reproduces forward (rel_err < 2e-3)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    m = build_model(smoke_config("rwkv6-1.6b").with_(dtype="float32"))
    p = m.init(0)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 512, (3, 10))
                            .astype(np.int32)).to(cuda)
    reset_launch_counts()
    full, _ = m.forward(p, {"tokens": toks})
    cache = m.init_cache(3, 12)
    dec = []
    for t in range(10):
        logits, cache = m.decode_step(p, cache, toks[:, t:t + 1],
                                      torch.full((3,), t, dtype=torch.int32, device=cuda))
        dec.append(logits[:, 0])
    assert launch_counts() == {"rmsnorm": 5 * 11, "flash_attention": 0,
                               "decode_attention": 0, "rglru_scan": 0, "wkv6": 2 * 11}
    assert rel_err(torch.stack(dec, 1), full) < 2e-3


@pytest.mark.gpu
def test_cuda_wrappers_refuse_autograd(cuda):
    x = torch.ones(2, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        rmsnorm(x, torch.zeros(64, device=cuda))
