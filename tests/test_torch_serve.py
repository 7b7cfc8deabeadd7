"""PyTorch port serving engine on the CPU: the JAX engine's behaviour
(tests/test_train_serve.py TestServingEngine) and the JAX engine's own
greedy tokens for the same weights and prompts."""

import numpy as np
import pytest
import jax
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.models import build_model as jax_build_model
from repro.serve import Request as JaxRequest, ServingEngine as JaxServingEngine
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as torch_serve
from repro_torch.models import build_model
from repro_torch.models.convert import load_jax_params
from repro_torch.serve import Request, ServingEngine

from torch_port_helpers import jax_tree_to_numpy


@pytest.fixture(scope="module")
def model_params():
    m = build_model(smoke_config("gemma-2b").with_(dtype="float32"), device="cpu")
    return m, m.init(0)


class TestServingEngine:
    def test_continuous_batching_drains(self, model_params):
        m, params = model_params
        eng = ServingEngine(m, params, n_slots=2, max_len=48)
        for i in range(5):
            eng.submit(Request(request_id=i, prompt=np.arange(1, 4, dtype=np.int32),
                               max_new_tokens=4))
        stats = eng.run_until_drained()
        assert stats.requests_finished == 5
        assert stats.tokens_generated == 20

    def test_steering_hook_cancels(self, model_params):
        m, params = model_params
        eng = ServingEngine(m, params, n_slots=2, max_len=48,
                            on_token=lambda req, tok: len(req.generated) >= 1)
        eng.submit(Request(request_id=0, prompt=np.asarray([1, 2], np.int32),
                           max_new_tokens=10))
        stats = eng.run_until_drained()
        assert stats.requests_cancelled == 1
        assert stats.tokens_generated == 1

    def test_prefix_isolation_between_slots(self, model_params):
        """Two different prompts decoded concurrently give the same tokens
        as decoded alone (slot isolation)."""
        m, params = model_params

        def gen(prompts):
            eng = ServingEngine(m, params, n_slots=len(prompts), max_len=48)
            for i, p in enumerate(prompts):
                eng.submit(Request(request_id=i, prompt=p, max_new_tokens=5))
            reqs = {}
            eng.on_finish = lambda r: reqs.setdefault(r.request_id, r.generated)
            eng.run_until_drained()
            return reqs

        p0 = np.asarray([5, 6, 7], np.int32)
        p1 = np.asarray([9, 10], np.int32)
        together = gen([p0, p1])
        assert together[0] == gen([p0])[0]
        assert together[1] == gen([p1])[0]

    def test_stats_count_decode_calls_and_keep_logits(self, model_params):
        """Every decode step is counted, prompt prefeed included, and the
        latest step's logits stay readable for a caller's checks."""
        m, params = model_params
        eng = ServingEngine(m, params, n_slots=2, max_len=48)
        prompts = [np.arange(1, 4, dtype=np.int32), np.arange(1, 6, dtype=np.int32)]
        for i, p in enumerate(prompts):
            eng.submit(Request(request_id=i, prompt=p, max_new_tokens=3))
        stats = eng.run_until_drained()
        assert stats.decode_calls == stats.steps + sum(len(p) - 1 for p in prompts)
        assert tuple(eng.last_logits.shape) == (2, 1, m.cfg.vocab_size)
        assert bool(torch.isfinite(eng.last_logits).all())

    def test_params_must_be_on_the_model_device(self, model_params):
        m, params = model_params
        moved = dict(params, embed=params["embed"].to("meta"))
        with pytest.raises(ValueError, match="model on cpu"):
            ServingEngine(m, moved, n_slots=2, max_len=8)


def _serve_all(engine_cls, request_cls, model, params, prompts, n_slots, max_len):
    done = {}
    eng = engine_cls(model, params, n_slots=n_slots, max_len=max_len,
                     on_finish=lambda r: done.setdefault(r.request_id, list(r.generated)))
    for i, p in enumerate(prompts):
        eng.submit(request_cls(request_id=i, prompt=p, max_new_tokens=6))
    stats = eng.run_until_drained()
    return done, stats, eng


def test_greedy_tokens_match_jax_engine():
    """Same weights, same prompts: the same tokens, slot reuse and idle
    slots running past max_len included."""
    jm = jax_build_model(jax_smoke_config("gemma-2b").with_(dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(smoke_config("gemma-2b").with_(dtype="float32"), device="cpu")
    params = load_jax_params(m, jax_tree_to_numpy(jp))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, m.cfg.vocab_size, size=rng.integers(2, 6)).astype(np.int32)
               for _ in range(5)]
    jdone, jstats, _ = _serve_all(JaxServingEngine, JaxRequest, jm, jp, prompts, 3, 12)
    tdone, tstats, eng = _serve_all(ServingEngine, Request, m, params, prompts, 3, 12)
    assert int(eng._lengths.max()) > 12          # a slot ran past the cache
    assert tdone == jdone
    assert (tstats.steps, tstats.tokens_generated) == (jstats.steps, jstats.tokens_generated)


def test_launch_run_returns_the_same_keys():
    out = torch_serve.run(n_requests=3, n_slots=2, max_new=3, device="cpu")
    ref = jax_serve.run(n_requests=3, n_slots=2, max_new=3)
    assert set(out) == set(ref)
    assert out["requests"] == ref["requests"] == 3
