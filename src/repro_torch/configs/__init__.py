"""Model configs of the port: the paper's OLMo family,
moonshot-v1-16b-a3b (MoE), deepseek-v2-236b (MLA and MoE) and
recurrentgemma-9b (RG-LRU blocks and windowed MQA)."""
from .base import get_config

__all__ = ["get_config"]
