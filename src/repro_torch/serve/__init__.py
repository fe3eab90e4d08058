"""MX serving in PyTorch: fused and chunked prefill, slab and paged KV
caches, continuous batching (see ``repro.serve``)."""
from .scheduler import Request, SamplingParams, Scheduler, sample_tokens
from .pages import PageAllocator, prefix_chain
from .engine import PagedServeEngine, ServeEngine, serving_params
from .decode import generate, prefill_into_cache

__all__ = ["Request", "SamplingParams", "Scheduler", "sample_tokens",
           "PageAllocator", "prefix_chain", "PagedServeEngine",
           "ServeEngine", "serving_params", "generate", "prefill_into_cache"]
