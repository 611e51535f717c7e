"""Robot specification (port of ``safe_control_tpu/core/spec.py``).

A frozen dataclass of Python floats plus the model name.  Field names,
defaults, the per-model default table and the ``make_spec`` override rules
are those of the JAX package, so a spec built either way holds the same
numbers (``interop.spec_from_jax`` carries one across).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

# Canonical model names.
SINGLE_INTEGRATOR_2D = "SingleIntegrator2D"
DOUBLE_INTEGRATOR_2D = "DoubleIntegrator2D"
UNICYCLE_2D = "Unicycle2D"
DYNAMIC_UNICYCLE_2D = "DynamicUnicycle2D"
KINEMATIC_BICYCLE_2D = "KinematicBicycle2D"
KINEMATIC_BICYCLE_2D_C3BF = "KinematicBicycle2D_C3BF"
KINEMATIC_BICYCLE_2D_DPCBF = "KinematicBicycle2D_DPCBF"
QUAD_2D = "Quad2D"
QUAD_3D = "Quad3D"
VTOL_2D = "VTOL2D"
DYNAMIC_BICYCLE_2D = "DynamicBicycle2D"
DRIFTING_CAR = "DriftingCar"
MANIPULATOR_2D = "Manipulator2D"


def _beta_from_delta(delta: float, wheel_base: float, rear_ax_dist: float) -> float:
    """Slip angle from steering angle."""
    return math.atan((rear_ax_dist / wheel_base) * math.tan(delta))


@dataclasses.dataclass(frozen=True)
class RobotSpec:
    """Superset of all per-model numeric parameters (Python floats)."""

    model: str

    # Geometry / limits (shared)
    radius: float = 0.25
    v_max: float = 1.0
    v_min: float = 0.0
    w_max: float = 0.5
    a_max: float = 1.0
    ax_max: float = 1.0
    ay_max: float = 1.0

    # Kinematic bicycle family
    wheel_base: float = 0.4
    body_width: float = 0.3
    front_ax_dist: float = 0.2
    rear_ax_dist: float = 0.2
    delta_max: float = math.radians(32.0)
    beta_max: float = _beta_from_delta(math.radians(32.0), 0.4, 0.2)

    # Quad2D / Quad3D / VTOL
    f_min: float = 3.0
    f_max: float = 10.0
    u_min: float = 0.0
    u_max: float = 10.0
    mass: float = 1.0
    inertia: float = 0.01
    ix: float = 0.5
    iy: float = 0.5
    iz: float = 0.5
    arm_length: float = 0.3
    nu_torque: float = 0.1

    # VTOL2D aerodynamics
    s_wing: float = 0.55
    rho_air: float = 1.2682
    c_l0: float = 0.23
    c_lalpha: float = 5.61
    m_blend: float = 50.0
    alpha_0: float = math.radians(15.0)
    c_ldelta_e: float = 0.13
    c_d0: float = 0.043
    c_dalpha: float = 0.03
    c_ddelta_e: float = 0.0
    c_m0: float = 0.0135
    c_malpha: float = -2.74
    c_mdelta_e: float = -0.99
    chord: float = 0.18994
    k_front: float = 70.0
    k_rear: float = 70.0
    k_pusher: float = 60.0
    ell_f: float = 0.5
    ell_r: float = 0.5
    throttle_min: float = 0.0
    throttle_max: float = 1.0
    elevator_min: float = -0.5
    elevator_max: float = 0.5
    descent_speed_max: float = 2.0
    pitch_max: float = 30.0  # degrees (VTOL)

    # Manipulator2D
    link_len_1: float = 80.0 / 60.0
    link_len_2: float = 70.0 / 60.0
    link_len_3: float = 50.0 / 60.0
    base_x: float = 0.0
    base_y: float = 0.0
    kp: float = 3.0
    manip_beta: float = 1.3

    # DynamicBicycle2D / DriftingCar
    a_cg: float = 1.6  # front axle to CG [m]
    b_cg: float = 0.8  # rear axle to CG [m]
    izz: float = 2500.0  # yaw inertia [kg m^2]
    cc_f: float = 80000.0  # front cornering stiffness [N/rad]
    cc_r: float = 120000.0  # rear cornering stiffness [N/rad]
    mu: float = 1.0  # friction coefficient
    r_w: float = 0.3  # wheel radius [m]
    gamma_stab: float = 0.99
    delta_dot_max: float = math.radians(60.0)
    tau_max: float = 5000.0
    tau_dot_max: float = 10000.0
    r_max: float = 2.0  # yaw-rate bound [rad/s]
    body_length: float = 4.3

    # Nominal-controller gains
    nominal_k_v: float = 1.0
    nominal_k_a: float = 1.0
    nominal_k_omega: float = 2.0

    # Continuous-time CBF gains
    cbf_alpha: float = 1.0
    cbf_alpha1: float = 1.5
    cbf_alpha2: float = 1.5
    cbf_beta: float = 1.01  # barrier margin multiplier on d_min^2

    # Discrete-time (MPC) CBF gains
    mpc_cbf_alpha: float = 0.05
    mpc_cbf_alpha1: float = 0.15
    mpc_cbf_alpha2: float = 0.15

    # Tracking orchestration
    reached_threshold: float = 0.3

    # Perception (FoV sensing)
    fov_angle: float = math.radians(70.0)
    cam_range: float = 3.0

    def replace(self, **kwargs: Any) -> "RobotSpec":
        return dataclasses.replace(self, **kwargs)


# Per-model default overrides (the same table as the JAX package).
_MODEL_DEFAULTS: Dict[str, Dict[str, float]] = {
    SINGLE_INTEGRATOR_2D: dict(
        v_max=1.0, w_max=0.5, cbf_alpha=1.0, mpc_cbf_alpha=0.05
    ),
    DOUBLE_INTEGRATOR_2D: dict(
        a_max=1.0, v_max=1.0, ax_max=1.0, ay_max=1.0, w_max=0.5,
        cbf_alpha1=1.5, cbf_alpha2=1.5, mpc_cbf_alpha1=0.2, mpc_cbf_alpha2=0.2,
    ),
    UNICYCLE_2D: dict(v_max=1.0, w_max=0.5, cbf_alpha=1.0, mpc_cbf_alpha=0.05),
    DYNAMIC_UNICYCLE_2D: dict(
        a_max=0.5, w_max=0.5, v_max=1.0,
        cbf_alpha1=1.5, cbf_alpha2=1.5, mpc_cbf_alpha1=0.15, mpc_cbf_alpha2=0.15,
    ),
    KINEMATIC_BICYCLE_2D: dict(
        wheel_base=0.4, body_width=0.3, radius=0.3, front_ax_dist=0.2,
        rear_ax_dist=0.2, v_max=3.5, a_max=5.0, v_min=0.2,
        cbf_alpha1=1.5, cbf_alpha2=1.5, cbf_beta=1.1,
        mpc_cbf_alpha1=0.1, mpc_cbf_alpha2=0.1,
    ),
    KINEMATIC_BICYCLE_2D_C3BF: dict(
        wheel_base=0.4, body_width=0.3, radius=0.3, front_ax_dist=0.2,
        rear_ax_dist=0.2, v_max=3.5, a_max=5.0, v_min=0.2,
        cbf_alpha=1.5, mpc_cbf_alpha=0.15, cbf_beta=1.1,
    ),
    KINEMATIC_BICYCLE_2D_DPCBF: dict(
        wheel_base=0.4, body_width=0.3, radius=0.3, front_ax_dist=0.2,
        rear_ax_dist=0.2, v_max=3.5, a_max=5.0, v_min=0.2,
        cbf_alpha=1.5, mpc_cbf_alpha=0.15, cbf_beta=1.1,
    ),
    QUAD_2D: dict(
        f_min=3.0, f_max=10.0, mass=1.0, inertia=0.01,
        cbf_alpha1=1.5, cbf_alpha2=1.5, mpc_cbf_alpha1=0.15, mpc_cbf_alpha2=0.15,
    ),
    QUAD_3D: dict(
        u_min=-10.0, u_max=10.0, mass=3.0, ix=0.5, iy=0.5, iz=0.5,
        arm_length=0.3, nu_torque=0.1, cbf_alpha=1.5, mpc_cbf_alpha=0.15,
    ),
    VTOL_2D: dict(
        mass=11.0, inertia=1.135, v_max=15.0, pitch_max=15.0,
        descent_speed_max=5.0, throttle_min=0.0, throttle_max=1.0,
        elevator_min=-0.5, elevator_max=0.5,
        cbf_alpha1=1.5, cbf_alpha2=1.5, mpc_cbf_alpha1=0.05, mpc_cbf_alpha2=0.05,
        reached_threshold=3.0,
    ),
    MANIPULATOR_2D: dict(w_max=2.0, kp=3.0, cbf_alpha=1.0),
    DYNAMIC_BICYCLE_2D: dict(
        mass=1500.0, izz=2500.0, a_cg=1.6, b_cg=0.8, wheel_base=2.4,
        cc_f=80000.0, cc_r=120000.0, mu=1.0, r_w=0.3, gamma_stab=0.99,
        delta_max=math.radians(35.0), delta_dot_max=math.radians(60.0),
        tau_max=5000.0, tau_dot_max=10000.0,
        v_max=30.0, v_min=0.5, r_max=2.0, beta_max=math.radians(60.0),
        body_length=4.3, body_width=1.8, front_ax_dist=1.6, rear_ax_dist=0.8,
        radius=1.2,
    ),
    DRIFTING_CAR: dict(
        mass=1500.0, izz=2500.0, a_cg=1.6, b_cg=0.8, wheel_base=2.4,
        cc_f=80000.0, cc_r=120000.0, mu=1.0, r_w=0.3, gamma_stab=0.99,
        delta_max=math.radians(35.0), delta_dot_max=math.radians(60.0),
        tau_max=5000.0, tau_dot_max=10000.0,
        v_max=30.0, v_min=0.5, r_max=2.0, beta_max=math.radians(60.0),
        body_length=4.3, body_width=1.8, front_ax_dist=1.6, rear_ax_dist=0.8,
        radius=1.2,
    ),
}


def make_spec(model: str, **overrides: Any) -> RobotSpec:
    """Build a :class:`RobotSpec` for ``model`` with the per-model defaults.

    ``overrides`` replace individual fields.  An ``a_max`` override on
    DoubleIntegrator2D also sets ``ax_max``/``ay_max`` unless given, and the
    KinematicBicycle2D family derives ``beta_max`` from the steering limit
    and geometry unless given.
    """
    params: Dict[str, Any] = dict(_MODEL_DEFAULTS.get(model, {}))
    if "a_max" in overrides and model == DOUBLE_INTEGRATOR_2D:
        overrides.setdefault("ax_max", overrides["a_max"])
        overrides.setdefault("ay_max", overrides["a_max"])
    if model.startswith("KinematicBicycle2D"):
        delta_max = overrides.get("delta_max", params.get("delta_max", math.radians(32.0)))
        wb = overrides.get("wheel_base", params.get("wheel_base", 0.4))
        rd = overrides.get("rear_ax_dist", params.get("rear_ax_dist", 0.2))
        overrides.setdefault("beta_max", _beta_from_delta(delta_max, wb, rd))
    params.update(overrides)
    valid = {f.name for f in dataclasses.fields(RobotSpec)}
    params = {k: v for k, v in params.items() if k in valid}
    return RobotSpec(model=model, **params)
