"""Model interface shared by all dynamics modules (port of ``dynamics/base.py``).

Every model module exposes the same function surface as its JAX original:
``N_STATES``, ``N_CONTROLS``, ``REL_DEG``, ``f``, ``g``, ``step``,
``nominal_input``, ``u_lb``/``u_ub``, ``state_bounds`` and ``barrier_pos``.
States carry any number of leading batch axes: ``step(x (B, n), u (B, m))``
works, and so does one unbatched ``(n,)`` state under ``torch.func``.
The model functions write nothing in place, because the MPC solver takes
forward-mode derivatives through them with ``torch.func.jvp``.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

import torch

from safe_control_tpu_torch.core.types import angle_normalize  # re-export for models

__all__ = [
    "angle_normalize", "masked_apply", "register", "get_model",
    "MODEL_REGISTRY", "free_bounds", "spec_vector",
]

MODEL_REGISTRY: Dict[str, ModuleType] = {}


def register(name: str, module: ModuleType) -> None:
    MODEL_REGISTRY[name] = module


def get_model(name: str) -> ModuleType:
    try:
        return MODEL_REGISTRY[name]
    except KeyError as exc:
        raise ValueError(
            f"model '{name}' is not yet ported to safe_control_tpu_torch "
            f"(ported: {sorted(MODEL_REGISTRY)})"
        ) from exc


def masked_apply(x, fn, lo: int, hi: int):
    """Apply an elementwise ``fn`` to the state components ``lo:hi``.

    Equivalent to ``x[..., lo:hi] = fn(x[..., lo:hi])`` written without an
    in-place write, so that ``torch.func`` transforms pass through it.
    """
    return torch.cat([x[..., :lo], fn(x[..., lo:hi]), x[..., hi:]], dim=-1)


def spec_vector(values, *, device=None, dtype=torch.float32):
    """Stack spec scalars into a vector on the last axis.

    Floats give ``(len(values),)``; the ``(B,)`` tensor fields of a batched
    spec give ``(B, len(values))``.
    """
    parts = [torch.as_tensor(v, device=device, dtype=dtype) for v in values]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def free_bounds(n: int, *, device=None, dtype=torch.float32):
    inf = float("inf")
    return (
        torch.full((n,), -inf, device=device, dtype=dtype),
        torch.full((n,), inf, device=device, dtype=dtype),
    )
