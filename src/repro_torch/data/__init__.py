"""Deterministic synthetic data of the port (see ``repro.data``)."""
from .synthetic import lm_batch, lm_input_arrays

__all__ = ["lm_batch", "lm_input_arrays"]
