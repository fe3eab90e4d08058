"""deepseek-v2-236b  [moe, mla]  (DeepSeek-V2, arXiv:2405.04434); see
``repro.configs.deepseek_v2_236b``.

60L d_model=5120 128H MLA (kv_lora=512, q_lora=1536, nope=128, rope=64,
v_head=128) expert d_ff=1536 vocab=102400, 2 shared + 160 routed top-6,
first layer dense (dense d_ff=12288).
"""
from repro_torch.models import LMConfig
from .base import register


def full() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
        n_kv_heads=128, d_head=128, d_ff=12288, vocab=102400, act="swiglu",
        norm="rmsnorm", mla=True, q_lora=1536, kv_lora=512, nope_dim=128,
        rope_dim=64, v_head=128, n_experts=160, top_k=6, n_shared=2,
        moe_dff=1536, first_dense=1, rope_theta=1e4,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=512, act="swiglu",
        norm="rmsnorm", mla=True, q_lora=48, kv_lora=32, nope_dim=16,
        rope_dim=8, v_head=16, n_experts=8, top_k=2, n_shared=1, moe_dff=48,
        first_dense=1, loss_chunk=128,
    )


register("deepseek-v2-236b", full, smoke)
