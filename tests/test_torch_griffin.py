"""PyTorch port Griffin (recurrentgemma-2b) vs the JAX package's, on the CPU.

The JAX ``Model.init(PRNGKey(0))`` tree of the reduced recurrentgemma-2b
config (3 layers: recurrent, recurrent, local attention) is loaded into
the port through ``load_jax_params``; forward, loss, decode and serving
then agree with JAX on the same tokens. rel_err bounds: 1e-4 for
port-vs-JAX in f32 (same math, other summation order), 2e-2 in bf16
(both round every intermediate to bf16, at other places), 2e-3 for
decode-vs-forward (tests/test_models_smoke.py).
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
from repro_torch.launch import serve as torch_serve
from repro_torch.models import build_model
from repro_torch.models.convert import load_jax_cache, load_jax_params
from repro_torch.serve import Request, ServingEngine

from torch_port_helpers import jax_tree_to_numpy, rel_err, to_np

ARCH = "recurrentgemma-2b"
B, S = 2, 10


def _pair(dtype="float32", **over):
    """(JAX model, JAX params, port model, port params) with equal weights."""
    jm = jax_build_model(jax_smoke_config(ARCH).with_(dtype=dtype, **over))
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(smoke_config(ARCH).with_(dtype=dtype, **over), device="cpu")
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


def test_param_tree_is_a_list_of_layer_kinds(pair):
    jm, jp, m, p = pair
    assert m.n_params() == jm.n_params()
    kinds = [next(iter(lp["temporal"])) for lp in p["layers"]]
    assert kinds == ["kind_rec", "kind_rec", "kind_attn"]
    assert tuple(p["layers"][0]["temporal"]["kind_rec"]["conv_w"].shape) == (4, 64)
    swapped = jax_tree_to_numpy(jp)
    swapped["layers"] = swapped["layers"][::-1]          # attention layer first
    with pytest.raises(KeyError, match="temporal"):
        load_jax_params(m, swapped)


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
    """The dtype steps of the RG-LRU (decay widened to f32, scale narrowed
    to bf16) follow the JAX function's."""
    jm, jp, m, p = _pair("bfloat16")
    toks = tokens[0]
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    assert rel_err(to_np(tl), np.asarray(jl, np.float32)) < 2e-2


@torch.no_grad()
@pytest.mark.parametrize("window", [16, 4])
def test_decode_matches_jax_forward(window, tokens):
    """Teacher-forced decode_step over S tokens reproduces JAX's forward;
    with a window of 4 the ring buffer wraps twice."""
    jm, jp, m, p = _pair(local_window=window)
    toks = tokens[0]
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    cache = m.init_cache(B, S + 2)
    assert cache["layers"][2]["attn"]["k"].shape[2] == min(window, S + 2)
    dec = []
    for t in range(S):
        logits, cache = m.decode_step(p, cache, torch.from_numpy(toks[:, t:t + 1]),
                                      torch.full((B,), t, dtype=torch.int32))
        dec.append(logits[:, 0])
    assert rel_err(to_np(torch.stack(dec, 1)), jl) < 2e-3


@torch.no_grad()
def test_jax_cache_continues_in_the_port(tokens):
    """A JAX cache after 5 decode steps (ring of 4 already wrapped) loads
    into the port, and the next 5 steps match JAX's own."""
    jm, jp, m, p = _pair(local_window=4)
    toks = tokens[0]
    jcache = jm.init_cache(B, S + 2)
    for t in range(5):
        _, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.full((B,), t, jnp.int32))
    tcache = load_jax_cache(m, jax_tree_to_numpy(jcache), S + 2)
    assert set(tcache["layers"][0]) == {"conv", "h"} and set(tcache["layers"][2]) == {"attn"}
    for t in range(5, S):
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.full((B,), t, jnp.int32))
        tlog, tcache = m.decode_step(p, tcache, torch.from_numpy(toks[:, t:t + 1]),
                                     torch.full((B,), t, dtype=torch.int32))
        assert rel_err(to_np(tlog), jlog) < 1e-4, t
    jc = load_jax_cache(m, jax_tree_to_numpy(jcache), S + 2)
    for tl, jl in zip(tcache["layers"], jc["layers"]):
        tl, jl = tl.get("attn", tl), jl.get("attn", jl)
        for key in tl:
            assert rel_err(to_np(tl[key]), to_np(jl[key])) < 1e-4, key


def _serve(engine_cls, request_cls, model, params, prompts, max_new, n_slots, max_len=32):
    done = {}
    eng = engine_cls(model, params, n_slots=n_slots, max_len=max_len,
                     on_finish=lambda r: done.setdefault(r.request_id, list(r.generated)))
    for i, (prompt, n) in enumerate(zip(prompts, max_new)):
        eng.submit(request_cls(request_id=i, prompt=prompt, max_new_tokens=n))
    stats = eng.run_until_drained()
    return done, (stats.steps, stats.tokens_generated), eng


def _h_states(eng):
    """Every recurrent layer's h, as f32 numpy, from either engine's cache."""
    return [np.asarray(to_np(l["h"]) if isinstance(l["h"], torch.Tensor) else l["h"], np.float32)
            for l in eng._cache["layers"] if "h" in l]


def test_engine_matches_jax_engine(pair):
    """2 slots, staggered admissions: the same token streams, steps and
    final recurrent states as the JAX engine on the same weights. The JAX
    engine prefeeds a prompt by decoding every slot, which advances the
    other slots' recurrent states; the port does the same."""
    jm, jp, m, p = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, m.cfg.vocab_size, size=n).astype(np.int32) for n in (3, 5, 2, 4)]
    max_new = [4, 6, 3, 5]
    jdone, jsteps, jeng = _serve(JaxServingEngine, JaxRequest, jm, jp, prompts, max_new, 2)
    tdone, tsteps, teng = _serve(ServingEngine, Request, m, p, prompts, max_new, 2)
    assert tdone == jdone
    assert tsteps == jsteps
    for th, jh in zip(_h_states(teng), _h_states(jeng)):
        assert rel_err(th, jh) < 1e-4


def test_engine_keeps_a_slots_recurrent_state_across_requests(pair):
    """Admitting a request resets only its slot's length, not its recurrent
    state, in both engines: a request served after another in the same
    slot ends in another state than on a fresh engine."""
    jm, jp, m, p = pair
    first, second = np.asarray([5, 6, 7], np.int32), np.asarray([9, 10], np.int32)
    states = {}
    for name, (eng_cls, req_cls, model, params) in {
            "jax": (JaxServingEngine, JaxRequest, jm, jp),
            "port": (ServingEngine, Request, m, p)}.items():
        _, _, after = _serve(eng_cls, req_cls, model, params, [first, second], [3, 3], 1)
        _, _, fresh = _serve(eng_cls, req_cls, model, params, [second], [3], 1)
        states[name] = (_h_states(after), _h_states(fresh))
    for (ja, jf), (ta, tf) in zip(zip(*states["jax"]), zip(*states["port"])):
        assert rel_err(ta, ja) < 1e-4 and rel_err(tf, jf) < 1e-4
        assert rel_err(ja, jf) > 1e-2                    # the state carried over


def test_launch_run_serves_griffin():
    out = torch_serve.run(arch=ARCH, n_requests=3, n_slots=2, max_new=3, device="cpu")
    ref = jax_serve.run(arch=ARCH, n_requests=3, n_slots=2, max_new=3)
    assert set(out) == set(ref)
    assert out["requests"] == ref["requests"] == 3
