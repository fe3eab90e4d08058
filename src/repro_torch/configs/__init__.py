"""Model configs of the port (the paper's OLMo family)."""
from .base import get_config

__all__ = ["get_config"]
