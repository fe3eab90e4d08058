"""moonshot-v1-16b-a3b  [moe]  (Moonlight-16B-A3B family); see
``repro.configs.moonshot_v1_16b_a3b``.

48L d_model=2048 16H (MHA, kv=16) expert d_ff=1408 vocab=163840,
MoE 64 routed top-6 + 2 shared experts, first layer dense
[hf:moonshotai/Moonlight-16B-A3B].
"""
from repro_torch.models import LMConfig
from .base import register


def full() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_ff=11264, vocab=163840, act="swiglu",
        norm="rmsnorm", n_experts=64, top_k=6, n_shared=2, moe_dff=1408,
        first_dense=1, rope_theta=5e4,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=512, act="swiglu",
        norm="rmsnorm", n_experts=8, top_k=2, n_shared=1, moe_dff=64,
        first_dense=1, loss_chunk=128,
    )


register("moonshot-v1-16b-a3b", full, smoke)
