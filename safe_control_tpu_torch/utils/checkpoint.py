"""Checkpoint and resume of batched simulation state.

Port of ``safe_control_tpu/utils/checkpoint.py``: a sweep's state (tracker
states, obstacle arrays, the steps done, metrics; any nesting of tuples,
named tuples, lists and dicts of tensors) is saved under ``path/step_<N>``
with ``torch.save`` and restored with ``torch.load`` onto the device of a
``like`` state, so that a preempted run resumes exactly.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

_FILE = "state.pt"


def _to_cpu(tree):
    return _map(tree, lambda t: t.detach().cpu())


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return tree


def _unpack(saved, like):
    """``saved`` (plain containers, as written) in the structure of ``like``,
    each tensor on the device of its counterpart."""
    if isinstance(like, torch.Tensor):
        return saved.to(like.device)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unpack(s, l) for s, l in zip(saved, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_unpack(s, l) for s, l in zip(saved, like))
    if isinstance(like, dict):
        return {k: _unpack(saved[k], v) for k, v in like.items()}
    return saved


def _plain(tree):
    """Named tuples as plain tuples, so that the file loads with
    ``weights_only`` (no classes pickled)."""
    if isinstance(tree, tuple):
        return tuple(_plain(v) for v in tree)
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def save(path: str, state: Any, step: int) -> str:
    """Save ``state`` under ``path/step_<step>``; returns the directory."""
    target = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(target, exist_ok=True)
    torch.save(_plain(_to_cpu(state)), os.path.join(target, _FILE))
    return target


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore(path: str, like: Any, step: Optional[int] = None) -> Any:
    """The state saved at ``step`` (default: the latest), in the structure
    of ``like`` and on its devices."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    target = os.path.join(os.path.abspath(path), f"step_{step}", _FILE)
    saved = torch.load(target, map_location="cpu", weights_only=True)
    return _unpack(saved, like)
