"""Decoder LM and the student-teacher proxy, in PyTorch (see
``repro.models``)."""
from .mla import (mla_apply, mla_decode, mla_decode_paged, mla_init,
                  mla_prefill)
from .proxy import (ProxyConfig, proxy_apply, proxy_batch, proxy_init,
                    proxy_loss, stack_lanes, teacher_init, unstack_lanes)
from .rglru import (rec_block_apply, rec_block_decode, rec_block_init,
                    rec_block_prefill, rglru_scan, rglru_step)
from .transformer import (LMConfig, block_plan, check_supported,
                          chunk_supported, init_cache, init_cache_paged,
                          kind_paged, layer_kinds, lm_apply, lm_decode_step,
                          lm_init, lm_loss, lm_prefill, lm_prefill_chunk,
                          paged_leaf_mask, prefill_supported, tree_map)

__all__ = ["LMConfig", "block_plan", "check_supported", "chunk_supported",
           "init_cache", "init_cache_paged", "kind_paged", "layer_kinds",
           "lm_apply", "paged_leaf_mask", "rec_block_apply",
           "rec_block_decode", "rec_block_init", "rec_block_prefill",
           "rglru_scan", "rglru_step",
           "lm_decode_step", "lm_init", "lm_loss", "lm_prefill",
           "lm_prefill_chunk", "prefill_supported",
           "tree_map", "mla_apply", "mla_decode", "mla_decode_paged",
           "mla_init", "mla_prefill", "ProxyConfig",
           "proxy_apply", "proxy_batch", "proxy_init", "proxy_loss",
           "teacher_init", "stack_lanes", "unstack_lanes"]
