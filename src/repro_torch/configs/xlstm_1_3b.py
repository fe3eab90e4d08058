"""xlstm-1.3b  [ssm]  (arXiv:2405.04517); see ``repro.configs.xlstm_1_3b``.

48 blocks d_model=2048 4H vocab=50304, pattern 7 x mLSTM + 1 x sLSTM,
d_ff=0: the feed-forward capacity lives inside the blocks (mLSTM
projection factor 2, sLSTM post-GeGLU 4/3).  The blocks' head size is
their own width over n_heads (1024 in the mLSTM, 512 in the sLSTM), not
d_head.
"""
from repro_torch.models import LMConfig
from .base import register


def full() -> LMConfig:
    return LMConfig(
        name="xlstm-1.3b", n_layers=48, d_model=2048, n_heads=4,
        n_kv_heads=4, d_head=512, d_ff=0, vocab=50304, act="geglu",
        norm="layernorm",
        block_pattern=("mlstm",) * 7 + ("slstm",),
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="xlstm-1.3b-smoke", n_layers=4, d_model=64, n_heads=2,
        n_kv_heads=2, d_head=32, d_ff=0, vocab=512, act="geglu",
        norm="layernorm", block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        loss_chunk=128,
    )


register("xlstm-1.3b", full, smoke)
