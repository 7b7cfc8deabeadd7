#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout with nvcc (sm_90a),
then runs these phases and fails (non-zero exit, no result line) if any
check fails:

1. kernel vs plain: every kernel against its plain PyTorch version at the
   main paths' shapes (decode attention with gemma-2b's group of 8 and
   recurrentgemma-2b's of 10; wkv6 at rwkv6-1.6b's 32 heads of 64), f32
   and bf16 (rel_err tolerances of tests/test_kernels.py: attention f32
   1e-4, norm f32 1e-5, rglru_scan f32 1e-4, wkv6 f32 1e-3, bf16 2e-2,
   rglru_scan and wkv6 bf16 3e-2);
2. gemma-2b decode vs forward: full width (18 layers, f32, random
   weights from seed 0); teacher-forced decode_step over 32 tokens for 2
   sequences reproduces forward's logits to rel_err < 2e-3;
3. gemma-2b serving: full width in bf16 through build_model and
   ServingEngine, 12 requests on 4 slots (max_new 16, max_len 128,
   steering on), which must drain with finite logits; then
   torch.profiler over 6 more steps with every slot decoding gives the
   device time per step by kind of kernel and its share of the step;
4. recurrentgemma-2b decode vs forward: full width, depth uncut (26
   layers, f32), 32 tokens with a ring buffer that holds them all, then
   40 tokens with local_window 16 so that the ring buffer wraps;
5. recurrentgemma-2b serving: as phase 3, in bf16 (ring window 128);
6. rwkv6-1.6b decode vs forward: full width, depth uncut (24 layers,
   f32), 32 tokens for 2 sequences from the zero state, reported: in f32
   this comparison is dominated by the model's own rounding at the first
   positions (PERF.md §6). It is held to 2e-3 in f64, through the same
   model code with f64 plain versions swapped in, and the kernels in f32
   are held to 2e-3 on a continuation: from the state a 32-token prefix
   leaves, one 32-token decode_step against 32 one-token steps;
7. rwkv6-1.6b serving: as phase 3, in bf16;
8. timing: each kernel, its plain version and one PyTorch library call
   for the same function where there is one, with CUDA events and the L2
   cache flushed before every launch, beside the least time the card
   could take;
9. the results: a line {"kernels": [...]}, the card's name and power
   limit, and last {"ok": true, "device": {...}}.

Launch counters are zeroed just before each forward, each decode loop
and each serving run of phases 2-7 and read just after; every kernel of
the path must have run exactly the expected number of times. Each
model's weights are freed before the next model's are made. Needs one
GPU; exits non-zero without one.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}   # bf16 tensor / f32 CUDA cores
ELEMENTWISE = {"rmsnorm", "rglru_scan"}   # no tensor-core form: the f32 CUDA-core peak bounds them
TOL = {("attn", torch.float32): 1e-4, ("norm", torch.float32): 1e-5,
       ("scan", torch.float32): 1e-4, ("wkv", torch.float32): 1e-3,
       ("attn", torch.bfloat16): 2e-2, ("norm", torch.bfloat16): 2e-2,
       ("scan", torch.bfloat16): 3e-2, ("wkv", torch.bfloat16): 3e-2}
DTYPES = (torch.bfloat16, torch.float32)
KERNEL_INFO = {
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:28"),
    "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:79"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:97"),
    "rglru_scan": ("src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/kernel.py:56"),
    "wkv6": ("src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
             "src/repro/kernels/wkv6/kernel.py:84"),
}
# Launches per layer kind of one forward and of one decode step: every
# layer has 2 rmsnorms and the final norm 1; an attention layer runs
# flash_attention in forward and decode_attention in decode; a recurrent
# layer (griffin) runs rglru_scan in both, and an rwkv6 layer wkv6.
LAYERS = {"gemma-2b": {"attn": 18, "rec": 0, "wkv": 0},
          "recurrentgemma-2b": {"attn": 8, "rec": 18, "wkv": 0},
          "rwkv6-1.6b": {"attn": 0, "rec": 0, "wkv": 24}}


def expected_launches(arch: str, forwards: int, decode_steps: int) -> dict:
    n = LAYERS[arch]
    calls = forwards + decode_steps
    return {"rmsnorm": (2 * sum(n.values()) + 1) * calls,
            "flash_attention": n["attn"] * forwards,
            "decode_attention": n["attn"] * decode_steps,
            "rglru_scan": n["rec"] * calls,
            "wkv6": n["wkv"] * calls}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


class Check(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise Check(msg)


# ---------------------------------------------------------------------------
# cases: the main path's shapes
# ---------------------------------------------------------------------------


def randn(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def rmsnorm_cases(gen, dev, dtype):
    for rows in (4, 512):
        x = randn(gen, (rows, 2048), dtype, dev)
        w = randn(gen, (2048,), dtype, dev, 0.1)
        byts = (2 * x.numel() + w.numel()) * x.element_size()
        ops = 4 * x.numel()
        yield f"rows={rows},D=2048", (x, w), dict(eps=1e-6, scale_offset=1.0), byts, ops


def decode_cases(gen, dev, dtype):
    # gemma-2b (8 q heads on 1 kv head): a serving cache and a long one;
    # recurrentgemma-2b (10 on 1): its 2048-slot ring buffer and the
    # serving run's 128-slot one
    for h, s, lengths in ((8, 128, [1, 37, 100, 128]), (8, 4096, [4000, 4093, 4095, 5000]),
                          (10, 2048, [1, 700, 2048, 2048]), (10, 128, [1, 37, 100, 128])):
        q = randn(gen, (4, h, 256), dtype, dev)
        k = randn(gen, (4, 1, s, 256), dtype, dev)
        v = randn(gen, (4, 1, s, 256), dtype, dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        valid = sum(min(n, s) for n in lengths)                 # cache rows read
        byts = (2 * q.numel() + 2 * valid * 256) * q.element_size() + lens.numel() * 4
        ops = 4 * h * valid * 256
        yield f"H={h},S={s},lengths={lengths}", (q, k, v, lens), {}, byts, ops


def flash_cases(gen, dev, dtype):
    # gemma-2b (8 q heads on 1 kv head), causal; recurrentgemma-2b (10 on
    # 1), its local attention window of 2048 over a 4096-token prompt
    for h, sq, skv, kw in ((8, 1024, 1024, dict(causal=True)),
                           (8, 1000, 1000, dict(causal=True)),
                           (8, 256, 1024, dict(causal=True, window=512, q_offset=768)),
                           (10, 4096, 4096, dict(causal=True, window=2048))):
        q = randn(gen, (1, h, sq, 256), dtype, dev)
        k = randn(gen, (1, 1, skv, 256), dtype, dev)
        v = randn(gen, (1, 1, skv, 256), dtype, dev)
        qp = torch.arange(sq, device=dev)[:, None] + kw.get("q_offset", 0)
        kp = torch.arange(skv, device=dev)[None, :]
        mask = kp <= qp
        if kw.get("window"):
            mask &= kp > qp - kw["window"]
        pairs = int(mask.sum())                                  # unmasked (q, k) pairs
        byts = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        ops = 4 * h * pairs * 256
        yield f"H={h},Sq={sq},Skv={skv},{kw}", (q, k, v), kw, byts, ops


def rglru_cases(gen, dev, dtype):
    # recurrentgemma-2b (D = 2560): a 2048-token prefill, a decode step of
    # 4 slots, an odd length, and extreme decay (log_a = -30, h0 = 100)
    for b, s, label in ((1, 2048, ""), (4, 1, ""), (2, 1000, ""), (2, 64, "log_a=-30,h0=100")):
        shape = (b, s, 2560)
        if label:
            log_a = torch.full(shape, -30.0, device=dev).to(dtype)
            x = torch.ones(shape, device=dev).to(dtype)
            h0 = torch.full((b, 2560), 100.0, device=dev).to(dtype)
        else:
            log_a = -torch.rand(shape, generator=gen, device=dev).mul(2.99).add(0.01).to(dtype)
            x = randn(gen, shape, dtype, dev)
            h0 = randn(gen, (b, 2560), dtype, dev)
        byts = (3 * x.numel() + 2 * h0.numel()) * x.element_size()
        ops = 3 * x.numel()                                      # exp, multiply, add
        yield f"B={b},S={s},D=2560{',' + label if label else ''}", (log_a, x, h0), {}, byts, ops


def wkv6_cases(gen, dev, dtype):
    # rwkv6-1.6b (H = 32, K = V = 64): a 2048-token prefill, a decode step
    # of 4 slots, an odd length, and extreme decay (lw = -50); r, k, v in
    # the activations' dtype, lw in [-4, -0.01], u and state0 random, all
    # three in f32 as the model passes them
    for b, s, label in ((1, 2048, ""), (4, 1, ""), (2, 1000, ""), (2, 64, "lw=-50")):
        shape = (b, 32, s, 64)
        r, k, v = (randn(gen, shape, dtype, dev, 0.5) for _ in range(3))
        if label:
            lw = torch.full(shape, -50.0, device=dev)
        else:
            lw = -torch.rand(shape, generator=gen, device=dev).mul(3.99).add(0.01)
        u = randn(gen, (32, 64), torch.float32, dev, 0.3)
        s0 = randn(gen, (b, 32, 64, 64), torch.float32, dev, 0.1)
        byts = 4 * r.numel() * r.element_size() + lw.numel() * 4 + u.numel() * 4 \
            + 2 * s0.numel() * 4                   # r, k, v, out; lw; u; state in and out
        ops = 4 * b * 32 * s * 64 * 64            # 2 multiply-adds per state element and step
        yield f"B={b},H=32,S={s},K=V=64{',' + label if label else ''}", \
            (r, k, v, lw, u, s0), {}, byts, ops


def library_call(name, args, kw):
    """One PyTorch call computing the same function (timed, never used by
    the port), or None where there is none."""
    if name in ("rglru_scan", "wkv6"):
        return None                 # no single PyTorch call computes the recurrence
    if name == "rmsnorm":
        x, w = args
        return lambda: x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + kw["eps"]) * (1 + w)
    if name == "decode_attention":
        q, k, v, lens = args
        pos = torch.arange(k.shape[2], device=q.device)
        mask = (pos[None, :] < lens[:, None])[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                                      enable_gqa=True)[:, :, 0]
    q, k, v = args
    if kw.get("causal") and not kw.get("window") and not kw.get("q_offset"):
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    sq, skv = q.shape[2], k.shape[2]
    qp = torch.arange(sq, device=q.device)[:, None] + kw.get("q_offset", 0)
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = kp <= qp
    if kw.get("window"):
        mask &= kp > qp - kw["window"]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels_vs_plain(ops, gen, dev, errors):
    for name, (kernel, plain, cases, kind) in ops.items():
        for dtype in DTYPES:
            for label, args, kw, _, _ in cases(gen, dev, dtype):
                outs, refs = kernel(*args, **kw), plain(*args, **kw)
                torch.cuda.synchronize()
                if isinstance(outs, torch.Tensor):
                    outs, refs = (outs,), (refs,)
                r = a = 0.0
                for out, ref in zip(outs, refs):
                    require(out.shape == ref.shape and out.dtype == ref.dtype,
                            f"{name} {label}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
                    require(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite output")
                    r, a = max(r, rel_err(out, ref)), max(a, abs_err(out, ref))
                tol = TOL[(kind, dtype)]
                errors[name]["rel"] = max(errors[name]["rel"], r)
                errors[name]["abs"] = max(errors[name]["abs"], a)
                log(f"[kernel vs plain] {name} {str(dtype)[6:]} {label}: rel_err={r:.3e} "
                    f"abs_err={a:.3e} tol={tol:g}")
                require(r < tol, f"{name} {label} {dtype}: rel_err {r:.3e} >= {tol:g}")


def decode_vs_forward(kernels, model, params, arch, B, S, dev, gated=True):
    """Teacher-forced decode_step over S tokens against one forward, with
    the launches of each checked; returns the launches of both, the tokens
    and both logits. ``gated=False`` reports the rel_err, by position too,
    without holding it to the bound (rwkv6: see rwkv6_f64_check)."""
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, model.cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        full, _ = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        fwd = kernels.launch_counts()
        cache = model.init_cache(B, S + 2)
        kernels.reset_launch_counts()
        dec = []
        for t in range(S):
            logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                              torch.full((B,), t, dtype=torch.int32, device=dev))
            dec.append(logits[:, 0])
        dec = torch.stack(dec, 1)
        torch.cuda.synchronize()
        steps = kernels.launch_counts()
    want_fwd, want_dec = expected_launches(arch, 1, 0), expected_launches(arch, 0, S)
    log(f"[decode vs forward] {arch} f32, {model.n_params()} params, B={B} S={S} "
        f"local_window={model.cfg.local_window}: launches forward {fwd} (expected {want_fwd}), "
        f"decode {steps} (expected {want_dec})")
    require(fwd == want_fwd, f"{arch} forward launches {fwd} != {want_fwd}")
    require(steps == want_dec, f"{arch} decode launches {steps} != {want_dec}")
    require(bool(torch.isfinite(full).all() and torch.isfinite(dec).all()),
            f"{arch} decode vs forward: non-finite logits")
    err = rel_err(dec, full)
    bound = "bound 2e-3" if gated else "bound 2e-3, reported"
    log(f"[decode vs forward] {arch} rel_err={err:.3e} ({bound}), logits {tuple(full.shape)}")
    if gated:
        require(err < 2e-3, f"{arch}: decode diverges from forward: rel_err {err:.3e}")
    else:
        log(f"[decode vs forward] {arch} rel_err by position: "
            + " ".join(f"{rel_err(dec[:, t], full[:, t]):.1e}" for t in range(S)))
    return {k: fwd[k] + steps[k] for k in fwd}, tokens, full, dec


def rwkv6_f64_check(model, params, tokens, full32, dec32):
    """The zero-state comparison again in float64, through the same model
    code with float64 plain versions of wkv6, rmsnorm and the group norm
    swapped in (the kernels take f32 and bf16 only). In f64 decode must
    reproduce forward (bound 2e-3); the f32 forward's distance from the f64
    one says how much of the f32 decode-vs-forward gap is the f32
    arithmetic of this model rather than the code."""
    from repro_torch.models import rwkv6

    def wkv6_f64(r, k, v, lw, u, state0):
        w, S = torch.exp(lw.double()), state0.double()
        r, k, v, u = r.double(), k.double(), v.double(), u.double()[None, :, :, None]
        out = torch.empty_like(v)
        for t in range(v.shape[2]):
            kv = k[:, :, t, :, None] * v[:, :, t, None, :]
            out[:, :, t] = (r[:, :, t, :, None] * (S + u * kv)).sum(-2)
            S = w[:, :, t, :, None] * S + kv
        return out, S

    def rms_norm_f64(x, w, eps=1e-6, offset=0.0):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (offset + w)

    def group_norm_f64(x, w, H, eps=64e-5):
        xg = x.unflatten(-1, (H, -1))
        var = xg.var(-1, unbiased=False, keepdim=True)
        xg = (xg - xg.mean(-1, keepdim=True)) * torch.rsqrt(var + eps)
        return xg.flatten(-2) * w

    def f64(tree):
        if isinstance(tree, dict):
            return {k: f64(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [f64(v) for v in tree]
        return tree.double()

    saved = rwkv6.wkv6, rwkv6.rms_norm, rwkv6._group_norm
    rwkv6.wkv6, rwkv6.rms_norm, rwkv6._group_norm = wkv6_f64, rms_norm_f64, group_norm_f64
    try:
        p64 = f64(params)
        B, S = tokens.shape
        with torch.no_grad():
            full, _ = model.forward(p64, {"tokens": tokens})
            cache, dec = f64(model.init_cache(B, S)), []
            for t in range(S):
                # rwkv6's decode_step does not read the lengths
                logits, cache = model.decode_step(p64, cache, tokens[:, t:t + 1], None)
                dec.append(logits[:, 0])
        dec = torch.stack(dec, 1)
    finally:
        rwkv6.wkv6, rwkv6.rms_norm, rwkv6._group_norm = saved
    err = rel_err(dec, full)
    log(f"[decode vs forward] {model.cfg.name} f64 plain: rel_err={err:.3e} (bound 2e-3); "
        f"f32 forward vs f64 forward rel_err={rel_err(full32, full):.3e}, "
        f"f32 decode vs f64 forward rel_err={rel_err(dec32, full):.3e}")
    log(f"[decode vs forward] {model.cfg.name} f32 forward vs f64 forward by position: "
        + " ".join(f"{rel_err(full32[:, t], full[:, t]):.1e}" for t in range(S)))
    require(err < 2e-3, f"{model.cfg.name}: f64 decode diverges from forward: rel_err {err:.3e}")


def continuation(kernels, model, params, arch, B, P, S, dev):
    """decode_step runs the same layer code for any number of tokens: from
    the state that a P-token prefix leaves, one call over S tokens against
    S one-token calls, both through the kernels, with the launches of each
    checked (bound 2e-3 on the logits); returns the launches of both."""
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, model.cfg.vocab_size, (B, P + S)).astype(np.int32)).to(dev)
    lengths = torch.zeros((B,), dtype=torch.int32, device=dev)     # unused by rwkv6
    with torch.no_grad():
        _, warm = model.decode_step(params, model.init_cache(B, P + S), tokens[:, :P], lengths)
        kernels.reset_launch_counts()
        one, one_state = model.decode_step(params, warm, tokens[:, P:], lengths)
        torch.cuda.synchronize()
        once = kernels.launch_counts()
        kernels.reset_launch_counts()
        state, dec = warm, []
        for t in range(P, P + S):
            logits, state = model.decode_step(params, state, tokens[:, t:t + 1], lengths)
            dec.append(logits[:, 0])
        dec = torch.stack(dec, 1)
        torch.cuda.synchronize()
        steps = kernels.launch_counts()
    want_once, want_steps = expected_launches(arch, 1, 0), expected_launches(arch, 0, S)
    require(once == want_once, f"{arch} {S}-token decode_step launches {once} != {want_once}")
    require(steps == want_steps, f"{arch} decode launches {steps} != {want_steps}")
    require(bool(torch.isfinite(one).all() and torch.isfinite(dec).all()),
            f"{arch} continuation: non-finite logits")
    err = rel_err(dec, one)
    state_err = max(rel_err(a[k], b[k]) for a, b in zip(state["layers"], one_state["layers"])
                    for k in a)
    log(f"[decode vs forward] {arch} f32 continuation after a {P}-token prefix, B={B}: "
        f"one {S}-token decode_step vs {S} one-token steps rel_err={err:.3e} (bound 2e-3), "
        f"final states rel_err={state_err:.3e}; launches {once} and {steps}")
    require(err < 2e-3, f"{arch}: continuation diverges: rel_err {err:.3e}")
    require(state_err < 2e-3, f"{arch}: continuation states diverge: rel_err {state_err:.3e}")
    return {k: once[k] + steps[k] for k in once}


def phase_decode_vs_forward(kernels, dev, arch):
    """Full width, depth uncut, f32, random weights from seed 0; for
    recurrentgemma-2b a second run with local_window 16 wraps the ring. For
    rwkv6-1.6b the zero-state comparison is reported and checked in f64,
    and the f32 kernels are held to the bound on a continuation."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).with_(dtype="float32")
    model = build_model(cfg)
    params = model.init(0)
    rwkv = cfg.family == "rwkv6"
    counts, tokens, full, dec = decode_vs_forward(kernels, model, params, arch, 2, 32, dev,
                                                  gated=not rwkv)
    if rwkv:
        rwkv6_f64_check(model, params, tokens, full, dec)
        more = continuation(kernels, model, params, arch, 2, 32, 32, dev)
        counts = {k: counts[k] + more[k] for k in counts}
    del full, dec
    if cfg.family == "griffin":
        wrapped = build_model(cfg.with_(local_window=16))     # same weights
        more = decode_vs_forward(kernels, wrapped, params, arch, 2, 40, dev)[0]
        counts = {k: counts[k] + more[k] for k in counts}
    del model, params
    free_memory()
    return counts


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def profile_serving(engine, cfg, step_ms, steps=6):
    """Device time per engine step by kind of kernel, with all 4 slots
    decoding (torch.profiler, CUDA activity), and its share of
    ``step_ms``, the step time measured without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request

    rng = np.random.default_rng(1)
    engine.on_token = None                 # no steering: keep every slot busy
    for i in range(engine.n_slots):
        prompt = rng.integers(1, cfg.vocab_size, size=3).astype(np.int32)
        engine.submit(Request(request_id=100 + i, prompt=prompt, max_new_tokens=steps + 4))
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side rows only (kernels, copies): an operator's row repeats its kernels' time
    kinds = {"rmsnorm": 0.0, "decode_attention": 0.0, "rglru_scan": 0.0, "wkv6": 0.0,
             "matmul": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = ev.key.lower()
        if "rmsnorm_kernel" in key:
            kind = "rmsnorm"
        elif "decode_kernel" in key:
            kind = "decode_attention"
        elif "rglru_scan_kernel" in key:
            kind = "rglru_scan"
        elif "wkv6_kernel" in key:
            kind = "wkv6"
        elif any(t in key for t in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
            kind = "matmul"
        else:
            kind = "other"
        kinds[kind] += ev.self_device_time_total
    busy = sum(kinds.values())
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12))
    log(f"[profile] {cfg.name} serving, 4 slots busy: " + json.dumps({
        "steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
        "device_ms_per_step": busy / steps / 1e3,
        "device_busy_share_of_unprofiled_step": busy / steps / 1e3 / step_ms,
        "device_ms_per_step_by_kind": {k: v / steps / 1e3 for k, v in kinds.items()}}))


def phase_serving(kernels, dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServingEngine

    cfg = get_config(arch)                             # bf16, full width
    model = build_model(cfg)
    params = model.init(0)
    with torch.no_grad():                              # warm-up: cuBLAS handles, allocator
        model.decode_step(params, model.init_cache(4, 8), torch.zeros((4, 1), dtype=torch.int32,
                          device=dev), torch.zeros((4,), dtype=torch.int32, device=dev))
    torch.cuda.synchronize()

    finite = torch.ones((), dtype=torch.bool, device=dev)
    checked_step = [-1]

    def on_token(req, tok):
        # every generating step's logits, all slots, checked once per step
        if engine.stats.steps != checked_step[0]:
            checked_step[0] = engine.stats.steps
            finite.logical_and_(torch.isfinite(engine.last_logits).all())
        # launch/serve.py's steering policy: abandon a repeated token
        return len(req.generated) >= 4 and len(set(req.generated[-4:])) == 1

    finished = []
    engine = ServingEngine(model, params, n_slots=4, max_len=128, on_token=on_token,
                           on_finish=finished.append)
    rng = np.random.default_rng(0)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    for i in range(12):
        prompt = rng.integers(1, cfg.vocab_size, size=rng.integers(2, 6)).astype(np.int32)
        engine.submit(Request(request_id=i, prompt=prompt, max_new_tokens=16))
    stats = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    calls = stats.decode_calls
    want = expected_launches(arch, 0, calls)
    ttft = [r.first_token_at - r.submitted_at for r in finished]
    result = {
        "requests": stats.requests_finished,
        "cancelled_by_steering": stats.requests_cancelled,
        "tokens": stats.tokens_generated,
        "tokens_per_s": stats.tokens_generated / wall,
        "median_ttft_s": float(np.median(ttft)),
        "engine_steps": stats.steps,
        "decode_calls": calls,
        "mean_step_ms": 1e3 * wall / calls,
        "wall_s": wall,
        "launches": counts,
    }
    log(f"[serving] {arch} bf16 full width: " + json.dumps(result))
    require(stats.requests_finished == 12 and len(finished) == 12, f"{arch} serving did not drain")
    require(all(1 <= len(r.generated) <= 16 for r in finished), "bad generation lengths")
    require(bool(finite), f"{arch} serving produced non-finite logits")
    require(counts == want, f"{arch} serving launches {counts} != {want}")
    profile_serving(engine, cfg, result["mean_step_ms"])
    del engine, model, params
    free_memory()
    return counts


def time_cold(fn, flush, iters=20, warmup=3):
    """Median ms of one call, L2 flushed before each (CUDA events)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def phase_timing(ops, gen, dev):
    flush = torch.empty(128 * 2 ** 20, dtype=torch.int32, device=dev)   # 512 MB > L2
    rows = {}
    for name, (kernel, plain, cases, _) in ops.items():
        for dtype in DTYPES:
            for i, (label, args, kw, byts, nops) in enumerate(cases(gen, dev, dtype)):
                t_bytes = byts / HBM_BYTES_PER_S
                t_ops = nops / PEAK_OPS_PER_S[torch.float32 if name in ELEMENTWISE else dtype]
                library = library_call(name, args, kw)
                row = {
                    "ms": time_cold(lambda: kernel(*args, **kw), flush),
                    "plain_ms": time_cold(lambda: plain(*args, **kw), flush),
                    "library_ms": time_cold(library, flush) if library else None,
                    "bound_ms": 1e3 * max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": byts, "operations": nops,
                }
                log(f"[timing] {name} {str(dtype)[6:]} {label}: " + json.dumps(row))
                if dtype == torch.bfloat16 and (name, i) in HEADLINE:
                    rows[name] = dict(row, shape=label, dtype="bfloat16")
    return rows


HEADLINE = {("rmsnorm", 1), ("decode_attention", 1), ("flash_attention", 0), ("rglru_scan", 0),
            ("wkv6", 0)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    t_start = time.monotonic()
    lib = _build.build(verbose=True)
    log(f"[build] {lib.name} in {time.monotonic() - t_start:.1f} s")
    _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ops = {
        "rmsnorm": (kernels.rmsnorm, rmsnorm_ref, rmsnorm_cases, "norm"),
        "decode_attention": (kernels.decode_attention, decode_attention_ref, decode_cases, "attn"),
        "flash_attention": (kernels.flash_attention, attention_ref, flash_cases, "attn"),
        "rglru_scan": (kernels.rglru_scan, rglru_scan_ref, rglru_cases, "scan"),
        "wkv6": (kernels.wkv6, wkv6_ref, wkv6_cases, "wkv"),
    }
    errors = {name: {"rel": 0.0, "abs": 0.0} for name in ops}

    t = time.monotonic()
    phase_kernels_vs_plain(ops, gen, dev, errors)
    log(f"[phase] kernel vs plain {time.monotonic() - t:.1f} s")
    by_path = {}
    for arch in ("gemma-2b", "recurrentgemma-2b", "rwkv6-1.6b"):
        t = time.monotonic()
        by_path[f"{arch} decode vs forward"] = phase_decode_vs_forward(kernels, dev, arch)
        log(f"[phase] {arch} decode vs forward {time.monotonic() - t:.1f} s")
        t = time.monotonic()
        by_path[f"{arch} serving"] = phase_serving(kernels, dev, arch)
        log(f"[phase] {arch} serving {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    timing = phase_timing(ops, gen, dev)
    log(f"[phase] timing {time.monotonic() - t:.1f} s")

    launches = {name: sum(counts[name] for counts in by_path.values()) for name in ops}
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the main path")
    report = []
    for name in ops:
        source, replaces = KERNEL_INFO[name]
        row = timing[name]
        report.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": errors[name]["abs"],
            "max_rel_err": errors[name]["rel"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"], "dtype": row["dtype"],
        })
    log(f"[total] {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
