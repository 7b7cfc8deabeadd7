"""PyTorch port dense transformer vs the JAX package's, on the CPU.

The JAX ``Model.init(PRNGKey(0))`` tree of the reduced gemma-2b config
(f32) is loaded into the port through ``load_jax_params``; forward,
loss, prefill and teacher-forced decode then agree with JAX on the same
tokens. rel_err bounds: 1e-4 for port-vs-JAX (same f32 math, other
summation order), 2e-3 for decode-vs-forward (tests/test_models_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import kvcache as jax_kvcache
from repro.models import transformer as jax_tmod
from repro_torch.configs import smoke_config
from repro_torch.models import build_model
from repro_torch.models import transformer as tmod
from repro_torch.models.convert import load_jax_cache, load_jax_params
from repro_torch.models.kvcache import update_cache

from torch_port_helpers import jax_tree_to_numpy, rel_err, to_np

B, S = 2, 12


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params) with equal weights."""
    jcfg = jax_smoke_config("gemma-2b").with_(dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(smoke_config("gemma-2b").with_(dtype="float32"), device="cpu")
    return jm, jp, m, load_jax_params(m, jax_tree_to_numpy(jp))


@pytest.fixture(scope="module")
def tokens(pair):
    vocab = pair[2].cfg.vocab_size
    rng = np.random.default_rng(7)
    return rng.integers(0, vocab, (B, S)).astype(np.int32), \
        rng.integers(0, vocab, (B, S)).astype(np.int32)


def test_config_copy_matches_reference():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    assert get_config("gemma-2b").__dict__ == jax_get_config("gemma-2b").__dict__
    assert smoke_config("gemma-2b").__dict__ == jax_smoke_config("gemma-2b").__dict__


def test_param_tree_shapes_and_count(pair):
    jm, jp, m, p = pair
    assert m.n_params() == jm.n_params()
    assert len(p["layers"]) == m.cfg.n_layers
    assert tuple(p["layers"][1]["attn"]["wq"].shape) == tuple(jp["layers"]["attn"]["wq"].shape[1:])
    own = m.init(0)
    assert all(tuple(a.shape) == tuple(b.shape) for a, b in
               zip(own["layers"][0]["ffn"].values(), p["layers"][0]["ffn"].values()))
    assert torch.equal(m.init(0)["embed"], own["embed"])        # seeded


@torch.no_grad()
def test_forward_and_loss_match_jax(pair, tokens):
    jm, jp, m, p = pair
    toks, labels = tokens
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, S, m.cfg.vocab_padded)
    assert rel_err(to_np(tl), jl) < 1e-4
    jloss, _ = jm.loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tloss, metrics = m.loss(p, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)})
    assert abs(float(tloss) - float(jloss)) < 1e-4 * abs(float(jloss))
    assert set(metrics) == {"ce_loss", "loss"}


@torch.no_grad()
def test_prefill_matches_jax(pair, tokens):
    jm, jp, m, p = pair
    toks = tokens[0][:, :7]
    jlog, jcache, jlen = jax_tmod.prefill(jm.cfg, jp, jm.init_cache(B, S + 4),
                                          {"tokens": jnp.asarray(toks)})
    tlog, tcache, tlen = tmod.prefill(m.cfg, p, m.init_cache(B, S + 4),
                                      {"tokens": torch.from_numpy(toks)})
    assert rel_err(to_np(tlog), jlog) < 1e-4
    assert np.array_equal(tlen.numpy(), np.asarray(jlen))
    jc = load_jax_cache(m, jax_tree_to_numpy(jcache), B, S + 4)
    for tl, jl in zip(tcache["layers"], jc["layers"]):
        assert rel_err(to_np(tl["k"]), to_np(jl["k"])) < 1e-4
        assert rel_err(to_np(tl["v"]), to_np(jl["v"])) < 1e-4


@torch.no_grad()
def test_teacher_forced_decode_matches_jax(pair, tokens):
    jm, jp, m, p = pair
    toks = tokens[0]
    jcache = jm.init_cache(B, S + 2)
    tcache = m.init_cache(B, S + 2)
    for t in range(10):
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.full((B,), t, jnp.int32))
        tlog, tcache = m.decode_step(p, tcache, torch.from_numpy(toks[:, t:t + 1]),
                                     torch.full((B,), t, dtype=torch.int32))
        assert rel_err(to_np(tlog), jlog) < 1e-4, t
    jc = load_jax_cache(m, jax_tree_to_numpy(jcache), B, S + 2)
    assert rel_err(to_np(tcache["layers"][-1]["k"]), to_np(jc["layers"][-1]["k"])) < 1e-4


@torch.no_grad()
@pytest.mark.parametrize("fill", ["prefill", "decode"])
def test_jax_cache_loads_at_a_batch_other_than_the_layer_count(pair, fill):
    """The JAX cache is stacked (leaves (n_layers, B, ...)); at B = 3 with
    2 layers, a batch read off a leaf's first axis would be the layer
    count. The loaded cache equals the port's own after the same steps."""
    jm, jp, m, p = pair
    b = 3
    assert b != m.cfg.n_layers and m.cfg.scan_layers
    toks = np.random.default_rng(11).integers(0, m.cfg.vocab_size, (b, 6)).astype(np.int32)
    if fill == "prefill":
        _, jcache, _ = jax_tmod.prefill(jm.cfg, jp, jm.init_cache(b, 8),
                                        {"tokens": jnp.asarray(toks)})
        _, tcache, _ = tmod.prefill(m.cfg, p, m.init_cache(b, 8),
                                    {"tokens": torch.from_numpy(toks)})
    else:
        jcache, tcache = jm.init_cache(b, 8), m.init_cache(b, 8)
        for t in range(toks.shape[1]):
            _, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                       jnp.full((b,), t, jnp.int32))
            _, tcache = m.decode_step(p, tcache, torch.from_numpy(toks[:, t:t + 1]),
                                      torch.full((b,), t, dtype=torch.int32))
    jc = load_jax_cache(m, jax_tree_to_numpy(jcache), b, 8)
    assert len(jc["layers"]) == m.cfg.n_layers
    for tl, jl in zip(tcache["layers"], jc["layers"]):
        want = (b, m.cfg.n_kv_heads, 8, m.cfg.head_dim)
        assert tuple(jl["k"].shape) == tuple(tl["k"].shape) == want
        assert rel_err(to_np(tl["k"]), to_np(jl["k"])) < 1e-4
        assert rel_err(to_np(tl["v"]), to_np(jl["v"])) < 1e-4


@torch.no_grad()
def test_decode_matches_forward(pair, tokens):
    """Teacher-forced decode reproduces the full forward (the port alone)."""
    _, _, m, p = pair
    toks = torch.from_numpy(tokens[0])
    full, _ = m.forward(p, {"tokens": toks})
    cache = m.init_cache(B, S + 2)
    dec = []
    for t in range(S):
        logits, cache = m.decode_step(p, cache, toks[:, t:t + 1],
                                      torch.full((B,), t, dtype=torch.int32))
        dec.append(logits[:, 0])
    assert rel_err(to_np(torch.stack(dec, 1)), to_np(full)) < 2e-3


@pytest.mark.parametrize("pos", [[3, 6], [6, 9], [-1, 2]])
def test_update_cache_matches_one_hot(pos):
    """Positions outside [0, max_len) write nothing, as JAX's one-hot blend."""
    rng = np.random.default_rng(3)
    ck, cv = (rng.standard_normal((2, 1, 6, 4)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((2, 1, 1, 4)).astype(np.float32) for _ in range(2))
    lens = np.asarray(pos, np.int32)
    jk, jv = jax_kvcache.update_cache(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kn),
                                      jnp.asarray(vn), jnp.asarray(lens))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    update_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(lens))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for b, p in enumerate(pos):
        if not 0 <= p < 6:
            np.testing.assert_array_equal(tk.numpy()[b], ck[b])


def test_unported_families_raise():
    cfg = smoke_config("gemma-2b").with_(family="moe")
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")
