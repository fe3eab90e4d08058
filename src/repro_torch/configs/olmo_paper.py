"""The paper's own OLMo sweep family (§3.1, Table 3); see
``repro.configs.olmo_paper``.

  n = 6..24: heads = n, depth = n, d_head = 64 (d_model = 64n), MLP 4x,
  context 512, GeLU, RoPE, no biases, LayerNorm, QK-norm, vocab 32000.
  "olmo-paper" registers n = 8 as the representative full config.
"""
from repro_torch.models import LMConfig
from .base import register


def olmo(n: int, vocab: int = 32000, context: int = 512) -> LMConfig:
    return LMConfig(
        name=f"olmo-n{n}", n_layers=n, d_model=64 * n, n_heads=n,
        n_kv_heads=n, d_head=64, d_ff=4 * 64 * n, vocab=vocab, act="gelu",
        norm="layernorm", qk_norm=True, qkv_bias=False, rope_theta=1e4,
        loss_chunk=2048,
    )


def full() -> LMConfig:
    return olmo(8)


def smoke() -> LMConfig:
    return LMConfig(
        name="olmo-paper-smoke", n_layers=2, d_model=128, n_heads=2,
        n_kv_heads=2, d_head=64, d_ff=512, vocab=512, act="gelu",
        norm="layernorm", qk_norm=True, loss_chunk=128,
    )


register("olmo-paper", full, smoke)
