"""Serving driver: continuous-batching engine + Colmena request steering.

A Thinker-side policy watches tokens as they stream (the paper's
multi-fidelity lesson: stop evaluating low-performing candidates early)
and cancels generations whose running score falls below a threshold.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..configs import smoke_config
from ..models import build_model
from ..serve import Request, ServingEngine


def run(arch: str = "gemma-2b", n_requests: int = 12, n_slots: int = 4,
        max_new: int = 16, steer: bool = True, device: str = "cuda"):
    cfg = smoke_config(arch).with_(dtype="float32")
    model = build_model(cfg, device=device)
    params = model.init(0)
    rng = np.random.default_rng(0)

    def on_token(req: Request, tok: int) -> bool:
        # steering policy: abandon degenerate generations (repeated token)
        if steer and len(req.generated) >= 4:
            if len(set(req.generated[-4:])) == 1:
                return True
        return False

    finished = []
    engine = ServingEngine(model, params, n_slots=n_slots, max_len=128,
                           on_token=on_token, on_finish=finished.append)
    t0 = time.monotonic()
    for i in range(n_requests):
        prompt = rng.integers(1, cfg.vocab_size, size=rng.integers(2, 6)).astype(np.int32)
        engine.submit(Request(request_id=i, prompt=prompt, max_new_tokens=max_new))
    stats = engine.run_until_drained()
    wall = time.monotonic() - t0
    ttft = [r.first_token_at - r.submitted_at for r in finished if r.first_token_at]
    return {
        "requests": stats.requests_finished,
        "cancelled_by_steering": stats.requests_cancelled,
        "tokens": stats.tokens_generated,
        "tokens_per_s": stats.tokens_generated / wall,
        "mean_occupancy": stats.mean_occupancy,
        "median_ttft_s": float(np.median(ttft)) if ttft else None,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--no-steer", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    print(json.dumps(run(args.arch, args.requests, args.slots, args.max_new,
                         steer=not args.no_steer, device=args.device), indent=2))


if __name__ == "__main__":
    main()
