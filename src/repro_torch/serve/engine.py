"""Batched serving engine with continuous batching + Colmena steering hooks.

Slots hold independent requests; each engine step decodes one token for
every slot (synchronized step, per-slot lengths). Finished slots (eos or
max tokens) are refilled from the admission queue without stopping the
batch — continuous batching. The engine exposes callbacks (``on_token``,
``on_finish``) that a Colmena Thinker uses for steering (e.g.
early-stopping low-value generations).

Behaviour follows ``repro.serve.engine`` step for step: prompts are fed
token by token through the same decode step, idle slots decode (and
write their caches) alongside active ones, and every slot's length
advances each step. An idle slot's length may pass ``max_len``; its
cache writes then change nothing and its attention covers the whole
cache, as in the JAX engine. With the recurrent families (griffin,
rwkv6) the JAX engine's behaviour is kept as well, though it is not
isolation: every prefeed step also advances the other slots' recurrent
states, and admitting a request resets its slot's length but not its
recurrent state (tests/test_torch_griffin.py, tests/test_torch_rwkv6.py).
Tensors live on the device of ``params``, which must be the model's.
Beyond the JAX engine, ``stats.decode_calls`` counts decode steps, prompt
prefeed included, and ``last_logits`` holds the logits of the latest one.
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..models.model_api import Model
from .decode import make_serve_step


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                   # (P,) int32
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    # filled by the engine:
    generated: List[int] = field(default_factory=list)
    submitted_at: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    cancelled: bool = False


@dataclass
class EngineStats:
    steps: int = 0
    tokens_generated: int = 0
    requests_finished: int = 0
    requests_cancelled: int = 0
    batch_occupancy_sum: float = 0.0
    decode_calls: int = 0                # decode steps run, prompt prefeed included

    @property
    def mean_occupancy(self) -> float:
        return self.batch_occupancy_sum / max(self.steps, 1)


class ServingEngine:
    """Continuous-batching engine over Model.decode_step."""

    def __init__(
        self,
        model: Model,
        params: Any,
        n_slots: int = 4,
        max_len: int = 256,
        on_token: Optional[Callable[[Request, int], bool]] = None,
        on_finish: Optional[Callable[[Request], None]] = None,
    ) -> None:
        self.model = model
        self.params = params
        self.device = params["embed"].device
        if self.device != model.device:
            raise ValueError(f"params on {self.device}, model on {model.device}")
        self.n_slots = n_slots
        self.max_len = max_len
        self.on_token = on_token
        self.on_finish = on_finish
        self.stats = EngineStats()

        self._admit: "queue.Queue[Request]" = queue.Queue()
        self._slots: List[Optional[Request]] = [None] * n_slots
        self._serve = make_serve_step(model)
        self._cache = model.init_cache(n_slots, max_len)
        self._lengths = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self._tokens = torch.zeros((n_slots, 1), dtype=torch.int32, device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.last_logits: Optional[torch.Tensor] = None

    # ----------------------------------------------------------------- admit
    def submit(self, req: Request) -> None:
        self._admit.put(req)

    def _try_fill_slots(self) -> None:
        for i in range(self.n_slots):
            if self._slots[i] is not None:
                continue
            try:
                req = self._admit.get_nowait()
            except queue.Empty:
                return
            self._prefill_slot(i, req)

    def _prefill_slot(self, i: int, req: Request) -> None:
        """Feed the prompt through decode steps for slot i.

        Other slots' KV caches are unaffected: their spurious cache writes
        land at the position their *next* real token will overwrite, and
        their outputs are discarded. Their recurrent states (recurrent
        families) do advance, as in the JAX engine. The last prompt token
        is NOT prefed — it becomes slot i's current input so the next
        engine step generates from it."""
        self._lengths[i] = 0
        for tok in req.prompt[:-1]:
            self._tokens[i, 0] = int(tok)
            _, self.last_logits, self._cache = self._serve(
                self.params, self._cache, self._tokens, self._lengths, self._gen)
            self.stats.decode_calls += 1
            self._lengths[i] += 1
        self._tokens[i, 0] = int(req.prompt[-1])
        self._slots[i] = req

    # ------------------------------------------------------------------ step
    def step(self) -> int:
        """One decode step for all active slots; returns #active."""
        self._try_fill_slots()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return 0
        nxt, self.last_logits, self._cache = self._serve(
            self.params, self._cache, self._tokens, self._lengths, self._gen)
        self.stats.decode_calls += 1
        nxt_np = nxt.cpu().numpy()
        self._tokens = nxt
        self._lengths += 1

        self.stats.steps += 1
        self.stats.batch_occupancy_sum += len(active) / self.n_slots
        for i in active:
            req = self._slots[i]
            tok = int(nxt_np[i, 0])
            if req.first_token_at is None:
                req.first_token_at = time.monotonic()
            req.generated.append(tok)
            self.stats.tokens_generated += 1
            stop = False
            if self.on_token is not None:
                stop = bool(self.on_token(req, tok))
                if stop:
                    req.cancelled = True
                    self.stats.requests_cancelled += 1
            if req.eos_token is not None and tok == req.eos_token:
                stop = True
            if len(req.generated) >= req.max_new_tokens:
                stop = True
            if stop:
                req.finished_at = time.monotonic()
                self.stats.requests_finished += 1
                if self.on_finish is not None:
                    self.on_finish(req)
                self._slots[i] = None
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> EngineStats:
        for _ in range(max_steps):
            if self.step() == 0 and self._admit.empty():
                break
        return self.stats
