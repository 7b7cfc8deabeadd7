"""serve_step: the single-token decode used by the engine."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.model_api import Model


def make_serve_step(model: Model, greedy: bool = True, temperature: float = 1.0) -> Callable:
    """Returns serve_step(params, cache, tokens, lengths, gen) ->
    (next_tokens (B,1) int32, logits (B,1,V), cache). ``gen`` is the
    ``torch.Generator`` of categorical sampling (unused when greedy)."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, lengths, gen: Optional[torch.Generator] = None):
        logits, cache = model.decode_step(params, cache, tokens, lengths)
        if greedy:
            nxt = torch.argmax(logits[:, -1], dim=-1)
        else:
            probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        return nxt[:, None].to(torch.int32), logits, cache

    return serve_step
