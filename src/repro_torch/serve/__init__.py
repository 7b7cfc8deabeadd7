"""Serving substrate: single-token decode step + continuous-batching engine."""

from .decode import make_serve_step
from .engine import ServingEngine, Request, EngineStats
