"""Config registry of the port (see ``repro.configs.base``).

Each module registers a FULL config (the published configuration) and a
SMOKE config (same family, reduced) that runs in the CPU tests.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.models import LMConfig

_REGISTRY: Dict[str, Dict[str, Callable[[], LMConfig]]] = {}


def register(name: str, full: Callable[[], LMConfig],
             smoke: Callable[[], LMConfig]) -> None:
    _REGISTRY[name] = {"full": full, "smoke": smoke}


def get_config(name: str, variant: str = "full") -> LMConfig:
    from . import (deepseek_v2_236b, moonshot_v1_16b_a3b,  # noqa: F401
                   olmo_paper, recurrentgemma_9b)  # (register)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port knows "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name][variant]()

