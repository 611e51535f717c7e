"""Fleet scenarios of the JAX package's tests, bench and example, as the
port's groups, specs and tensors.

- ``corridor_fleet``: ``tests/test_fleet.py::_mk``'s 24 robots (DI, DU and
  DPCBF bicycles, 8 each) in three corridors around one obstacle;
- ``lattice_fleet``: ``examples/heterogeneous_fleet.py``'s anchor 5, three
  families of ``n // 3`` robots in serpentine lattices, 4 waypoints each;
- ``two_walls``: ``tests/test_fleet_shielded.py::build_fleet``'s opposing
  walls of DU and DI robots under gatekeeper shielding;
- ``three_family_anchor``: ``bench.py::build_shielded_fleet_3fam``'s
  head-on lanes of DU, KB and DI robots (``2 * rows`` agents).

Each returns ``(groups, specs, x0s, waypoints, n_waypoints, known_obs)`` on
``device``; the random jitters come from ``np.random.default_rng(0)``
drawn in the JAX package's order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from safe_control_tpu_torch.core.spec import (
    DOUBLE_INTEGRATOR_2D,
    DYNAMIC_UNICYCLE_2D,
    KINEMATIC_BICYCLE_2D,
    KINEMATIC_BICYCLE_2D_DPCBF,
    make_spec,
)
from safe_control_tpu_torch.core.types import pad_obstacles
from safe_control_tpu_torch.parallel import fleet as fleet_mod
from safe_control_tpu_torch.shielding import gatekeeper as gk_mod
from safe_control_tpu_torch.sim import tracking

_F32 = torch.float32


def _tensor(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _tracked_groups(count):
    def cfg(name):
        return tracking.TrackerConfig(model_name=name, pos_controller="cbf_qp", dt=0.05,
                                      num_obs=8, qp_iters=400)

    groups = [fleet_mod.FleetGroup(cfg(DOUBLE_INTEGRATOR_2D), count, 0.25),
              fleet_mod.FleetGroup(cfg(DYNAMIC_UNICYCLE_2D), count, 0.25),
              fleet_mod.FleetGroup(cfg(KINEMATIC_BICYCLE_2D_DPCBF), count, 0.3)]
    specs = [make_spec(DOUBLE_INTEGRATOR_2D, v_max=0.7, a_max=1.5, radius=0.25),
             make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.8, v_max=0.7, radius=0.25),
             make_spec(KINEMATIC_BICYCLE_2D_DPCBF, a_max=5.0, v_max=1.0, radius=0.3)]
    return groups, specs


def corridor_fleet(device="cuda"):
    """24 robots, 8 a family, each with one goal 3 m down its corridor."""
    groups, specs = _tracked_groups(8)
    rng = np.random.default_rng(0)

    def line(n, x0, y0, dx, dy):
        x = np.zeros((n, 4), dtype=np.float32)
        x[:, 0] = x0 + dx * np.arange(n) + rng.uniform(-0.1, 0.1, n)
        x[:, 1] = y0 + dy * np.arange(n) + rng.uniform(-0.1, 0.1, n)
        x[:, 3] = 0.3
        return x

    x0s = [line(8, 1.0, 2.0, 1.2, 0.0), line(8, 1.0, 12.0, 1.2, 0.0),
           line(8, 2.0, 4.5, 1.2, 0.0)]
    wps = []
    for x in x0s:
        g = x[:, :2].copy()
        g[:, 0] += 3.0
        wps.append(_tensor(g[:, None, :], device))
    known = pad_obstacles([[7.0, 7.0, 1.0, 0, 0, 0, 0]], 4, device=device)
    return groups, specs, [_tensor(x, device) for x in x0s], wps, [1, 1, 1], known


def lattice_fleet(n=4096, device="cuda"):
    """Three families of ``n // 3`` robots in lattices 3 m apart (bands at y
    = 0, 200, 400), each on a serpentine of 4 legs."""
    per = n // 3
    groups, specs = _tracked_groups(per)
    rng = np.random.default_rng(0)

    def lattice(y0):
        cols = int(np.ceil(np.sqrt(per)))
        x = np.zeros((per, 4), dtype=np.float32)
        idx = np.arange(per)
        x[:, 0] = 3.0 * (idx % cols) + rng.uniform(-0.2, 0.2, per)
        x[:, 1] = y0 + 3.0 * (idx // cols) + rng.uniform(-0.2, 0.2, per)
        x[:, 3] = 0.3
        return x

    x0s = [lattice(0.0), lattice(200.0), lattice(400.0)]
    wps = []
    for x0 in x0s:
        g0 = x0[:, :2]
        legs = []
        for dx, dy in [(8.0, 3.0), (16.0, -3.0), (24.0, 3.0), (32.0, 0.0)]:
            leg = g0.copy()
            leg[:, 0] += dx
            leg[:, 1] += dy
            legs.append(leg)
        wps.append(_tensor(np.stack(legs, axis=1), device))
    known = pad_obstacles(torch.zeros((0, 7)), 4, device=device)
    return groups, specs, [_tensor(x, device) for x in x0s], wps, [4, 4, 4], known


def _wp(ys, xg, device):
    w = np.zeros((len(ys), 1, 2), np.float32)
    w[:, 0, 0] = xg
    w[:, 0, 1] = ys
    return _tensor(w, device)


def two_walls(n_per_group=32, device="cuda"):
    """DU robots from x=0 heading +x and DI robots from x=8 heading -x on
    lanes 1.6 m apart (offset 0.4 lane), two static obstacles between."""
    gk = gk_mod.GatekeeperConfig(model_name=DYNAMIC_UNICYCLE_2D, dt=0.05, nominal_steps=16,
                                 backup_steps=16, event_offset_steps=4, discount_steps=4,
                                 revalidate=True)
    groups = [
        fleet_mod.ShieldedGroup(model_name=DYNAMIC_UNICYCLE_2D, count=n_per_group, gk=gk,
                                robot_radius=0.25),
        fleet_mod.ShieldedGroup(model_name=DOUBLE_INTEGRATOR_2D, count=n_per_group,
                                gk=dataclasses.replace(gk, model_name=DOUBLE_INTEGRATOR_2D),
                                robot_radius=0.25),
    ]
    specs = [make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.8, v_max=0.6, radius=0.25),
             make_spec(DOUBLE_INTEGRATOR_2D, v_max=0.6, a_max=1.5, radius=0.25)]
    lane = 1.6
    y = lane * np.arange(n_per_group)
    x0_du = np.zeros((n_per_group, 4), np.float32)
    x0_du[:, 1] = y
    x0_du[:, 3] = 0.3
    x0_di = np.zeros((n_per_group, 4), np.float32)
    x0_di[:, 0] = 8.0
    x0_di[:, 1] = y + 0.4 * lane
    x0_di[:, 2] = -0.3
    known = pad_obstacles(np.array([[4.0, 0.8, 0.4, 0, 0, 0, 0],
                                    [4.0, float(lane * n_per_group - 1.6), 0.4, 0, 0, 0, 0]],
                                   np.float32), 4, device=device)
    return (groups, specs, [_tensor(x0_du, device), _tensor(x0_di, device)],
            [_wp(y, 8.0, device), _wp(y + 0.4 * lane, 0.0, device)], [1, 1], known)


def three_family_anchor(rows, device="cuda"):
    """``rows`` lanes 1.6 m apart: even rows DU and odd rows KB (v_min 0)
    from x=0 heading +x, one DI a row from x=4 heading -x at 0.32 m lateral
    offset; safety margin 0.25."""
    if rows % 2:
        raise ValueError("rows must be even")
    gk = gk_mod.GatekeeperConfig(model_name=DYNAMIC_UNICYCLE_2D, dt=0.05, nominal_steps=16,
                                 backup_steps=16, event_offset_steps=4, discount_steps=4,
                                 revalidate=True)
    n_du = n_kb = rows // 2
    n_di = rows
    margin = 0.25
    groups = [
        fleet_mod.ShieldedGroup(model_name=DYNAMIC_UNICYCLE_2D, count=n_du, gk=gk,
                                safety_margin=margin),
        fleet_mod.ShieldedGroup(model_name=KINEMATIC_BICYCLE_2D, count=n_kb,
                                gk=dataclasses.replace(gk, model_name=KINEMATIC_BICYCLE_2D),
                                safety_margin=margin),
        fleet_mod.ShieldedGroup(model_name=DOUBLE_INTEGRATOR_2D, count=n_di,
                                gk=dataclasses.replace(gk, model_name=DOUBLE_INTEGRATOR_2D),
                                safety_margin=margin),
    ]
    specs = [make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.8, v_max=0.6, radius=0.25),
             make_spec(KINEMATIC_BICYCLE_2D, a_max=1.0, v_max=0.6, radius=0.25, v_min=0.0),
             make_spec(DOUBLE_INTEGRATOR_2D, v_max=0.6, a_max=1.5, radius=0.25)]
    lane = 1.6
    y_du = lane * (2.0 * np.arange(n_du))
    y_kb = lane * (2.0 * np.arange(n_kb) + 1.0)
    y_di = lane * np.arange(n_di) + 0.2 * lane
    x0_du = np.zeros((n_du, 4), np.float32)
    x0_du[:, 1] = y_du
    x0_du[:, 3] = 0.3
    x0_kb = np.zeros((n_kb, 4), np.float32)
    x0_kb[:, 1] = y_kb
    x0_kb[:, 3] = 0.3
    x0_di = np.zeros((n_di, 4), np.float32)
    x0_di[:, 0] = 4.0
    x0_di[:, 1] = y_di
    x0_di[:, 2] = -0.3
    wps = [_wp(y_du, 8.0, device), _wp(y_kb, 8.0, device), _wp(y_di, 0.0, device)]
    known = pad_obstacles(torch.zeros((0, 7)), 4, device=device)
    return (groups, specs, [_tensor(x, device) for x in (x0_du, x0_kb, x0_di)], wps,
            [1, 1, 1], known)
