"""PyTorch port RWKV-6 (rwkv6-1.6b) vs the JAX package's, on the CPU.

The JAX ``Model.init(PRNGKey(0))`` tree of the reduced rwkv6-1.6b config
(2 layers, d_model 64, 4 heads of 16) is stacked (``scan_layers``); it is
loaded into the port through ``load_jax_params``, and forward, loss,
decode and serving then agree with JAX on the same tokens. B = 3, so that
the batch differs from the layer count on the stacked trees. rel_err
bounds: 1e-4 for port-vs-JAX in f32 (same math, other summation order),
2e-2 in bf16 (both round every intermediate to bf16, at other places),
2e-3 for decode-vs-forward (tests/test_models_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.models import build_model as jax_build_model
from repro.serve import Request as JaxRequest, ServingEngine as JaxServingEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import serve as torch_serve
from repro_torch.models import build_model
from repro_torch.models.convert import load_jax_cache, load_jax_params
from repro_torch.serve import Request, ServingEngine

from torch_port_helpers import jax_tree_to_numpy, rel_err, to_np

ARCH = "rwkv6-1.6b"
B, S = 3, 10


def _pair(dtype="float32"):
    """(JAX model, JAX params, port model, port params) with equal weights."""
    jm = jax_build_model(jax_smoke_config(ARCH).with_(dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(smoke_config(ARCH).with_(dtype=dtype), device="cpu")
    return jm, jp, m, load_jax_params(m, jax_tree_to_numpy(jp))


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(7)
    vocab = smoke_config(ARCH).vocab_size
    return rng.integers(0, vocab, (B, S)).astype(np.int32), \
        rng.integers(0, vocab, (B, S)).astype(np.int32)


def test_config_copy_matches_reference():
    assert get_config(ARCH).__dict__ == jax_get_config(ARCH).__dict__
    assert smoke_config(ARCH).__dict__ == jax_smoke_config(ARCH).__dict__


def test_param_tree_unstacks_the_jax_layers(pair):
    jm, jp, m, p = pair
    cfg = m.cfg
    assert cfg.scan_layers and cfg.n_layers == 2 and cfg.rwkv_head_dim == 16
    assert m.n_params() == jm.n_params()
    assert len(p["layers"]) == cfg.n_layers
    assert tuple(jp["layers"]["tmix"]["u"].shape) == (cfg.n_layers, 4, 16)
    for i, lp in enumerate(p["layers"]):
        assert tuple(lp["tmix"]["u"].shape) == (4, 16)
        np.testing.assert_array_equal(lp["cmix"]["wk"].numpy(),
                                      np.asarray(jp["layers"]["cmix"]["wk"][i]))
    assert not torch.equal(p["embed"], p["unembed"])            # untied


@torch.no_grad()
def test_forward_and_loss_match_jax(pair, tokens):
    jm, jp, m, p = pair
    toks, labels = tokens
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = m.forward(p, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, S, m.cfg.vocab_padded) and aux == {}
    assert rel_err(to_np(tl), jl) < 1e-4
    last, _ = m.forward(p, {"tokens": torch.from_numpy(toks)}, last_only=True)
    assert rel_err(to_np(last), to_np(tl[:, -1:])) < 1e-6     # another matmul shape only
    jloss, _ = jm.loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tloss, metrics = m.loss(p, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)})
    assert abs(float(tloss) - float(jloss)) < 1e-4 * abs(float(jloss))
    assert set(metrics) == {"ce_loss", "loss"}


@torch.no_grad()
def test_bf16_forward_matches_jax(tokens):
    """The dtype steps of the time mix (LoRA clipped in bf16, log decay
    narrowed to bf16 and widened at the kernel, the WKV state and the group
    norm in f32) follow the JAX function's."""
    jm, jp, m, p = _pair("bfloat16")
    toks = tokens[0]
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    assert rel_err(to_np(tl), np.asarray(jl, np.float32)) < 2e-2
    assert m.init_cache(B, 4)["layers"][0]["wkv"].dtype == torch.float32


@torch.no_grad()
def test_decode_matches_jax_forward(pair, tokens):
    """Teacher-forced decode_step over S tokens reproduces JAX's forward;
    every step runs the wkv6 op once per layer and rmsnorm 2 per layer
    plus the final norm."""
    jm, jp, m, p = pair
    toks = tokens[0]
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    cache = m.init_cache(B, S + 2)
    dec = []
    for t in range(S):
        logits, cache = m.decode_step(p, cache, torch.from_numpy(toks[:, t:t + 1]),
                                      torch.full((B,), t, dtype=torch.int32))
        dec.append(logits[:, 0])
    assert rel_err(to_np(torch.stack(dec, 1)), jl) < 2e-3
    assert cache["layers"][0]["wkv"].shape == (B, 4, 16, 16)


@torch.no_grad()
def test_jax_state_continues_in_the_port(pair, tokens):
    """A JAX state after 5 decode steps (stacked: leaves (2, 3, ...)) loads
    into the port, and the next 5 steps match JAX's own."""
    jm, jp, m, p = pair
    toks = tokens[0]
    jcache = jm.init_cache(B, S + 2)
    for t in range(5):
        _, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.full((B,), t, jnp.int32))
    assert np.asarray(jcache["layers"]["wkv"]).shape[:2] == (m.cfg.n_layers, B)
    tcache = load_jax_cache(m, jax_tree_to_numpy(jcache), B, S + 2)
    assert [set(st) for st in tcache["layers"]] == [{"tmix_x", "cmix_x", "wkv"}] * 2
    for t in range(5, S):
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.full((B,), t, jnp.int32))
        tlog, tcache = m.decode_step(p, tcache, torch.from_numpy(toks[:, t:t + 1]),
                                     torch.full((B,), t, dtype=torch.int32))
        assert rel_err(to_np(tlog), jlog) < 1e-4, t
    jc = load_jax_cache(m, jax_tree_to_numpy(jcache), B, S + 2)
    for tl, jl in zip(tcache["layers"], jc["layers"]):
        for key in tl:
            assert tl[key].dtype == jl[key].dtype
            assert rel_err(to_np(tl[key]), to_np(jl[key])) < 1e-4, key


@torch.no_grad()
def test_multi_token_decode_step_continues_like_jax(pair, tokens):
    """decode_step runs the same layer code for any number of tokens: from
    the state a 4-token prefix leaves, one 6-token call equals JAX's and the
    port's own 6 one-token steps (chip_smoke.py's continuation check)."""
    jm, jp, m, p = pair
    toks = tokens[1]
    zeros, jzeros = torch.zeros((B,), dtype=torch.int32), jnp.zeros((B,), jnp.int32)
    _, jwarm = jm.decode_step(jp, jm.init_cache(B, S), jnp.asarray(toks[:, :4]), jzeros)
    jlog, jstate = jm.decode_step(jp, jwarm, jnp.asarray(toks[:, 4:]), jzeros)
    _, warm = m.decode_step(p, m.init_cache(B, S), torch.from_numpy(toks[:, :4]), zeros)
    one, one_state = m.decode_step(p, warm, torch.from_numpy(toks[:, 4:]), zeros)
    assert one.shape == (B, S - 4, m.cfg.vocab_padded)
    assert rel_err(to_np(one), jlog) < 1e-4
    state, steps = warm, []
    for t in range(4, S):
        logits, state = m.decode_step(p, state, torch.from_numpy(toks[:, t:t + 1]), zeros)
        steps.append(logits)
    assert rel_err(to_np(torch.cat(steps, 1)), to_np(one)) < 1e-4
    jc = load_jax_cache(m, jax_tree_to_numpy(jstate), B, S)
    for a, b, c in zip(state["layers"], one_state["layers"], jc["layers"]):
        for key in a:
            assert rel_err(to_np(a[key]), to_np(b[key])) < 1e-4, key
            assert rel_err(to_np(b[key]), to_np(c[key])) < 1e-4, key


def _serve(engine_cls, request_cls, model, params, prompts, max_new, n_slots, max_len=32):
    done = {}
    eng = engine_cls(model, params, n_slots=n_slots, max_len=max_len,
                     on_finish=lambda r: done.setdefault(r.request_id, list(r.generated)))
    for i, (prompt, n) in enumerate(zip(prompts, max_new)):
        eng.submit(request_cls(request_id=i, prompt=prompt, max_new_tokens=n))
    stats = eng.run_until_drained()
    return done, (stats.steps, stats.tokens_generated), eng


def _wkv_states(eng, n_layers):
    """Every layer's WKV state as f32 numpy, from either engine's cache
    (the JAX one stacks the layers)."""
    layers = eng._cache["layers"]
    if isinstance(layers, dict):
        return [np.asarray(layers["wkv"][i], np.float32) for i in range(n_layers)]
    return [to_np(st["wkv"]) for st in layers]


def test_engine_matches_jax_engine(pair):
    """2 slots, staggered admissions: the same token streams, steps and
    final WKV states as the JAX engine on the same weights. The JAX engine
    prefeeds a prompt by decoding every slot, which advances the other
    slots' recurrent states; the port does the same (ROADMAP §3)."""
    jm, jp, m, p = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, m.cfg.vocab_size, size=n).astype(np.int32) for n in (3, 5, 2, 4)]
    max_new = [4, 6, 3, 5]
    jdone, jsteps, jeng = _serve(JaxServingEngine, JaxRequest, jm, jp, prompts, max_new, 2)
    tdone, tsteps, teng = _serve(ServingEngine, Request, m, p, prompts, max_new, 2)
    assert tdone == jdone
    assert tsteps == jsteps
    n = m.cfg.n_layers
    for ts, js in zip(_wkv_states(teng, n), _wkv_states(jeng, n)):
        assert rel_err(ts, js) < 1e-4


def test_cpu_path_launches_no_kernel(pair, tokens):
    _, _, m, p = pair
    reset_launch_counts()
    with torch.no_grad():
        m.forward(p, {"tokens": torch.from_numpy(tokens[0])})
    assert set(launch_counts().values()) == {0}


def test_launch_run_serves_rwkv6():
    out = torch_serve.run(arch=ARCH, n_requests=3, n_slots=2, max_new=3, device="cpu")
    ref = jax_serve.run(arch=ARCH, n_requests=3, n_slots=2, max_new=3)
    assert set(out) == set(ref)
    assert out["requests"] == ref["requests"] == 3
