"""recurrentgemma-9b  [hybrid]  (Griffin, arXiv:2402.19427); see
``repro.configs.recurrentgemma_9b``.

38 blocks d_model=4096, pattern (rec, rec, attn): RG-LRU blocks and local
MQA (window 2048, kv=1, d_head=256), d_ff=12288 GeGLU, d_rnn=4096,
vocab=256000, RMSNorm.
"""
from repro_torch.models import LMConfig
from .base import register


def full() -> LMConfig:
    return LMConfig(
        name="recurrentgemma-9b", n_layers=38, d_model=4096, n_heads=16,
        n_kv_heads=1, d_head=256, d_ff=12288, vocab=256000, act="geglu",
        norm="rmsnorm", block_pattern=("rec", "rec", "attn"), window=2048,
        d_rnn=4096, rope_theta=1e4,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="recurrentgemma-9b-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=1, d_head=16, d_ff=128, vocab=512, act="geglu",
        norm="rmsnorm", block_pattern=("rec", "rec", "attn"), window=32,
        d_rnn=96, loss_chunk=128,
    )


register("recurrentgemma-9b", full, smoke)
