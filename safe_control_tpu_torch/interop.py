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
from safe_control_tpu_torch.parallel.fleet import (
    FleetGroup,
    FleetState,
    ShieldedFleetState,
    ShieldedGroup,
)
from safe_control_tpu_torch.parallel.monte_carlo import SweepState
from safe_control_tpu_torch.perception.fov import ObsMemory
from safe_control_tpu_torch.perception.grid import GridSpec
from safe_control_tpu_torch.shielding.backup_cbf import BackupCBFConfig
from safe_control_tpu_torch.shielding.gatekeeper import GatekeeperConfig, GatekeeperState
from safe_control_tpu_torch.sim.tracking import TrackerConfig, TrackerState
from safe_control_tpu_torch.solvers.al_gn import ALGNConfig
from safe_control_tpu_torch.solvers.mpc_cbf import MPCConfig, MPCState
from safe_control_tpu_torch.solvers.mpcc import MPCCConfig, Path


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


def _array(a, device, dtype):
    """An array as a tensor: floating as ``dtype``, integer as int64, bool as bool."""
    a = np.array(a)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, dtype=torch.long, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def mpcc_config_from_jax(cfg) -> MPCCConfig:
    """An :class:`MPCCConfig` with every field of the JAX ``MPCCConfig``."""
    values = _fields(MPCCConfig, cfg)
    values["al"] = ALGNConfig(**{k: getattr(cfg.al, k) for k in ALGNConfig._fields})
    return MPCCConfig(**values)


def path_from_jax(path, device=None, dtype=torch.float32) -> Path:
    """A :class:`Path` holding the JAX ``Path``'s arrays as they are."""
    return Path(*(torch.as_tensor(np.array(a), dtype=dtype, device=device) for a in path))


def gatekeeper_config_from_jax(cfg) -> GatekeeperConfig:
    return GatekeeperConfig(**_fields(GatekeeperConfig, cfg))


def gatekeeper_state_from_numpy(state, device=None, dtype=torch.float32) -> GatekeeperState:
    """A :class:`GatekeeperState` from the JAX state's arrays, each with a
    leading batch axis (one is added to an unbatched state)."""
    batched = np.ndim(state.time_idx) == 1
    conv = lambda a: _array(a if batched else np.asarray(a)[None], device, dtype)
    return GatekeeperState(*(conv(getattr(state, f)) for f in GatekeeperState._fields))


def backup_cbf_config_from_jax(cfg) -> BackupCBFConfig:
    return BackupCBFConfig(**_fields(BackupCBFConfig, cfg))


def sweep_state_from_numpy(state, device=None, dtype=torch.float32) -> SweepState:
    """A :class:`SweepState` from the JAX ``SweepState``'s tracker and
    obstacle arrays (``jax.vmap``-batched) and its step count."""
    return SweepState(tracker=tracker_state_from_numpy(state.tracker, device, dtype),
                      obs=_array(state.obs, device, dtype),
                      steps_done=torch.as_tensor(int(np.asarray(state.steps_done)),
                                                 dtype=torch.long, device=device))


def tracker_state_from_numpy(state, device=None, dtype=torch.float32) -> TrackerState:
    """A :class:`TrackerState` read from an object with the JAX
    ``TrackerState``'s attributes, each an array with a leading batch axis
    (as ``jax.vmap`` makes them).  Floating fields become ``dtype``, integer
    fields int64, masks bool.
    """

    def conv(a):
        return _array(a, device, dtype)

    return TrackerState(
        x=conv(state.x), yaw=conv(state.yaw), mode=conv(state.mode),
        goal_idx=conv(state.goal_idx), u_prev=conv(state.u_prev),
        mpc=MPCState(U=conv(state.mpc.U), lam=conv(state.mpc.lam)),
        mem=ObsMemory(slots=conv(state.mem.slots), valid=conv(state.mem.valid)),
        ret=conv(state.ret), footprint=conv(state.footprint),
        att_gk=GatekeeperAttState(*(conv(getattr(state.att_gk, f))
                                    for f in GatekeeperAttState._fields)),
    )


def fleet_group_from_jax(g) -> FleetGroup:
    """A :class:`FleetGroup` with the JAX group's count and radius and its
    ``TrackerConfig`` converted."""
    return FleetGroup(cfg=tracker_config_from_jax(g.cfg), count=g.count,
                      robot_radius=g.robot_radius)


def shielded_group_from_jax(g) -> ShieldedGroup:
    """A :class:`ShieldedGroup` with the JAX group's fields and its
    ``GatekeeperConfig`` converted."""
    values = _fields(ShieldedGroup, g)
    values["gk"] = gatekeeper_config_from_jax(g.gk)
    return ShieldedGroup(**values)


def fleet_state_from_numpy(state, device=None, dtype=torch.float32) -> FleetState:
    """A :class:`FleetState` from the JAX ``FleetState``'s batched trackers."""
    return FleetState(trackers=tuple(tracker_state_from_numpy(t, device, dtype)
                                     for t in state.trackers))


def shielded_fleet_state_from_numpy(state, device=None,
                                    dtype=torch.float32) -> ShieldedFleetState:
    """A :class:`ShieldedFleetState` from the JAX one: per group the states,
    the goal indices and counters (as int64), and the ``jax.vmap``-batched
    ``GatekeeperState``."""
    conv = lambda parts: tuple(_array(a, device, dtype) for a in parts)
    return ShieldedFleetState(
        x=conv(state.x), goal_idx=conv(state.goal_idx),
        gk=tuple(gatekeeper_state_from_numpy(s, device, dtype) for s in state.gk),
        backup_steps=conv(state.backup_steps), commits=conv(state.commits))


def ghosts_from_numpy(ghosts, device=None) -> torch.Tensor:
    """A warehouse ghost table ``(G, 5)`` as a float32 tensor."""
    return torch.as_tensor(np.array(ghosts), dtype=torch.float32, device=device)
