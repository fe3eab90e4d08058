"""Model configs of the port: the paper's OLMo family and
moonshot-v1-16b-a3b (MoE)."""
from .base import get_config

__all__ = ["get_config"]
