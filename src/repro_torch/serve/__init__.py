"""MX serving in PyTorch: fused prefill + continuous batching (slab cache)."""
from .scheduler import Request, SamplingParams, Scheduler, sample_tokens
from .engine import ServeEngine, serving_params

__all__ = ["Request", "SamplingParams", "Scheduler", "sample_tokens",
           "ServeEngine", "serving_params"]
