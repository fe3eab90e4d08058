"""Decoder LM for serving, in PyTorch (see ``repro.models``)."""
from .transformer import (LMConfig, block_plan, check_supported, init_cache,
                          lm_decode_step, lm_init, lm_prefill,
                          prefill_supported, tree_map)

__all__ = ["LMConfig", "block_plan", "check_supported", "init_cache",
           "lm_decode_step", "lm_init", "lm_prefill", "prefill_supported",
           "tree_map"]
