"""Carry parameters and solver state across from the JAX package.

The system has no learned weights: its parameters are the robot spec, the
solver and tracker configs, and the warm-start and tracker state.  These
helpers read them from the JAX package's objects by attribute (they never
import JAX), so that a test can hand both packages identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from safe_control_tpu_torch.attitude.gatekeeper_att import GatekeeperAttConfig, GatekeeperAttState
from safe_control_tpu_torch.core.spec import RobotSpec
from safe_control_tpu_torch.perception.fov import ObsMemory
from safe_control_tpu_torch.perception.grid import GridSpec
from safe_control_tpu_torch.sim.tracking import TrackerConfig, TrackerState
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


def _fields(cls, obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def grid_from_jax(gs):
    """A :class:`GridSpec` with the fields of the JAX ``GridSpec`` (None stays None)."""
    return None if gs is None else GridSpec(**_fields(GridSpec, gs))


def gk_att_config_from_jax(cfg) -> GatekeeperAttConfig:
    """A :class:`GatekeeperAttConfig` with every field of the JAX one."""
    return GatekeeperAttConfig(**_fields(GatekeeperAttConfig, cfg))


def tracker_config_from_jax(cfg) -> TrackerConfig:
    """A :class:`TrackerConfig` with every field of the JAX ``TrackerConfig``,
    its ``MPCConfig``, ``GatekeeperAttConfig`` and ``GridSpec`` converted."""
    values = _fields(TrackerConfig, cfg)
    values.update(mpc=config_from_jax(cfg.mpc), gk_att=gk_att_config_from_jax(cfg.gk_att),
                  grid=grid_from_jax(cfg.grid))
    return TrackerConfig(**values)


def tracker_state_from_numpy(state, device=None, dtype=torch.float32) -> TrackerState:
    """A :class:`TrackerState` read from an object with the JAX
    ``TrackerState``'s attributes, each an array with a leading batch axis
    (as ``jax.vmap`` makes them).  Floating fields become ``dtype``, integer
    fields int64, masks bool.
    """

    def conv(a):
        a = np.array(a)
        if a.dtype == np.bool_:
            return torch.as_tensor(a, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a, dtype=torch.long, device=device)
        return torch.as_tensor(a, dtype=dtype, device=device)

    return TrackerState(
        x=conv(state.x), yaw=conv(state.yaw), mode=conv(state.mode),
        goal_idx=conv(state.goal_idx), u_prev=conv(state.u_prev),
        mpc=MPCState(U=conv(state.mpc.U), lam=conv(state.mpc.lam)),
        mem=ObsMemory(slots=conv(state.mem.slots), valid=conv(state.mem.valid)),
        ret=conv(state.ret), footprint=conv(state.footprint),
        att_gk=GatekeeperAttState(*(conv(getattr(state.att_gk, f))
                                    for f in GatekeeperAttState._fields)),
    )
