"""Model configs of the port: the paper's OLMo family,
moonshot-v1-16b-a3b (MoE), deepseek-v2-236b (MLA and MoE),
recurrentgemma-9b (RG-LRU blocks and windowed MQA) and xlstm-1.3b (mLSTM
and sLSTM blocks)."""
from .base import get_config

__all__ = ["get_config"]
