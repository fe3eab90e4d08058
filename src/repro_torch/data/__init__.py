"""Deterministic synthetic data of the port (see ``repro.data``)."""
from .synthetic import lm_batch

__all__ = ["lm_batch"]
