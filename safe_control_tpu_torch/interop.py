"""Carry parameters and solver state across from the JAX package.

The system has no learned weights: its parameters are the robot spec, the
solver config and the warm-start state.  These helpers read them from the
JAX package's objects by attribute (they never import JAX), so that a test
can hand both packages identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from safe_control_tpu_torch.core.spec import RobotSpec
from safe_control_tpu_torch.solvers.mpc_cbf import MPCConfig, MPCState


def spec_from_jax(obj, device=None, dtype=torch.float32) -> RobotSpec:
    """A :class:`RobotSpec` with every field of ``obj``.

    Scalar fields are read as ``float``; the array fields of a batched spec
    become ``(B,)`` tensors of ``dtype`` on ``device``.
    """
    values = {}
    for f in dataclasses.fields(RobotSpec):
        v = getattr(obj, f.name)
        if f.name == "model":
            values[f.name] = v
        elif np.ndim(v) == 0:
            values[f.name] = float(v)
        else:
            values[f.name] = torch.as_tensor(np.array(v), dtype=dtype, device=device)
    return RobotSpec(**values)


def qp_from_numpy(P, q, A, l, u, device=None, dtype=torch.float32):
    """The batched QP data ``(P, q, A, l, u)`` as tensors, from arrays."""
    return tuple(
        torch.as_tensor(np.asarray(a), dtype=dtype, device=device).contiguous()
        for a in (P, q, A, l, u)
    )


def config_from_jax(cfg) -> MPCConfig:
    """An :class:`MPCConfig` with every field of the JAX ``MPCConfig``."""
    return MPCConfig(**{name: getattr(cfg, name) for name in MPCConfig._fields})


def state_from_numpy(U, lam, device=None, dtype=torch.float32) -> MPCState:
    """An :class:`MPCState` from ``U (B, N, m)`` and ``lam (B, n_con)`` arrays."""
    return MPCState(
        U=torch.as_tensor(np.asarray(U), dtype=dtype, device=device),
        lam=torch.as_tensor(np.asarray(lam), dtype=dtype, device=device),
    )
