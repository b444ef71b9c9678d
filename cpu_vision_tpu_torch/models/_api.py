"""Model registry.

Counterpart of the JAX package's ``models/_api.py`` (and of the reference's
``torchvision/models/_api.py``): ``register_model``, ``list_models``,
``get_model_builder`` and ``get_model``.  The ``Weights`` / ``WeightsEnum``
metadata carriers name checkpoint files; they wait until such files are in
the repository, and until then a model's parameters are drawn from a
``torch.Generator`` or carried across with ``models._convert``.
"""

from __future__ import annotations

import fnmatch
from typing import Any, Callable, Dict, List, Optional

__all__ = ["register_model", "list_models", "get_model", "get_model_builder"]

_MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: Optional[str] = None):
    """Decorator registering a model's factory function under ``name``
    (default: the function's own name)."""

    def wrapper(fn: Callable) -> Callable:
        key = name if name is not None else fn.__name__
        if key in _MODEL_REGISTRY:
            raise ValueError(f"model {key!r} already registered")
        _MODEL_REGISTRY[key] = fn
        return fn

    return wrapper


def list_models(include: Optional[str] = None, exclude: Optional[str] = None) -> List[str]:
    """Registered model names, optionally filtered by glob patterns."""
    names = set(_MODEL_REGISTRY)
    if include:
        names = set(fnmatch.filter(names, include))
    if exclude:
        names -= set(fnmatch.filter(names, exclude))
    return sorted(names)


def get_model_builder(name: str) -> Callable:
    name = name.lower()
    if name not in _MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; known: {sorted(_MODEL_REGISTRY)[:10]}...")
    return _MODEL_REGISTRY[name]


def get_model(name: str, **config) -> Any:
    """Build a model by name; ``config`` goes to its factory function."""
    return get_model_builder(name)(**config)
