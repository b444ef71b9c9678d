"""Checkpoints (PyTorch).

Counterpart of the JAX package's ``train/checkpoint.py``, on ``torch.save``
and ``torch.load`` where it has orbax: a dict of state (parameters, optimizer
state, epoch counters, ...) saved to one file and restored as it was saved.
``load_params`` reads a local file only: nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_params"]


def save_checkpoint(path: str, state: Any) -> None:
    """Save ``state`` (a dict of tensors, numbers, nested dicts and lists) to
    ``path``, replacing the file at once (written beside it, then renamed)."""
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """The state saved by :func:`save_checkpoint` at ``path``.  With
    ``target`` (a dict of like-shaped tensors), each tensor comes back in its
    target's dtype and on its device, as orbax restores into a target."""
    state = torch.load(os.path.abspath(path), weights_only=True)
    return state if target is None else _like(state, target)


def _like(state: Any, target: Any) -> Any:
    if isinstance(target, dict):
        return {k: _like(state[k], v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_like(s, t) for s, t in zip(state, target))
    if isinstance(target, torch.Tensor):
        return state.to(dtype=target.dtype, device=target.device)
    return state


def load_params(path: str) -> Any:
    """Model parameters from the local checkpoint ``path``.  A URL raises:
    there is no network, so weights must be placed in a file first."""
    if "://" in path:
        raise ValueError(f"load_params reads local files only, got the URL {path!r}")
    if not os.path.exists(path):
        raise FileNotFoundError(f"weights {path!r} not found")
    return load_checkpoint(path)
