"""Serving substrate: engine, router, request objects, samplers."""

from repro_torch.serving.engine import GenStats, InferenceEngine, measure_fn  # noqa: F401
from repro_torch.serving.requests import Request, Response  # noqa: F401
from repro_torch.serving.router import EnergyAwareRouter, OnlineRouter, RoutingPlan  # noqa: F401
from repro_torch.serving.sampler import Sampler  # noqa: F401
