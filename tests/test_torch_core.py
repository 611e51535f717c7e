"""Port parity: core types, robot specs and the JAX interop helpers.

Every case feeds the same numpy inputs to the JAX package and to the
PyTorch port and requires exact agreement (these are table lookups and
exact float operations).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core import spec as jspec
from safe_control_tpu.core import types as jtypes
from safe_control_tpu.solvers import mpc_cbf as jmpc
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.core import spec as tspec
from safe_control_tpu_torch.core import types as ttypes

torch.set_num_threads(1)

MODEL_NAMES = [
    jspec.SINGLE_INTEGRATOR_2D, jspec.DOUBLE_INTEGRATOR_2D, jspec.UNICYCLE_2D,
    jspec.DYNAMIC_UNICYCLE_2D, jspec.KINEMATIC_BICYCLE_2D,
    jspec.KINEMATIC_BICYCLE_2D_C3BF, jspec.KINEMATIC_BICYCLE_2D_DPCBF,
    jspec.QUAD_2D, jspec.QUAD_3D, jspec.VTOL_2D, jspec.DYNAMIC_BICYCLE_2D,
    jspec.DRIFTING_CAR, jspec.MANIPULATOR_2D,
]


def _fields_equal(port_spec, jax_spec):
    for f in dataclasses.fields(tspec.RobotSpec):
        assert getattr(port_spec, f.name) == getattr(jax_spec, f.name), f.name


@pytest.mark.parametrize(
    "obs",
    [
        np.zeros((0, 7)),
        np.array([2.0, 3.0, 0.5]),  # one short row
        np.array([[1.0, 2.0, 0.3], [4.0, 5.0, 0.6]]),  # short rows: zero-extended
        np.arange(27.0).reshape(3, 9),  # too wide: truncated to 7 columns
        np.arange(56.0).reshape(8, 7),  # too many rows: truncated to num_obs
    ],
    ids=["empty", "1d", "short", "wide", "many"],
)
def test_pad_obstacles_and_is_dummy(obs):
    want = np.asarray(jtypes.pad_obstacles(jnp.asarray(obs), 5))
    got = ttypes.pad_obstacles(obs, 5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ttypes.is_dummy(torch.as_tensor(got)).numpy(),
        np.asarray(jtypes.is_dummy(jnp.asarray(want))),
    )
    np.testing.assert_array_equal(
        ttypes.dummy_obstacle().numpy(), np.asarray(jtypes.dummy_obstacle())
    )


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_angle_normalize_matches_jnp_mod(dtype):
    """Floor-mod semantics for negative angles and at +-pi (not fmod)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(-20.0, 20.0, 200),
        [math.pi, -math.pi, 0.0, -0.0, 2 * math.pi, -2 * math.pi, 3 * math.pi,
         -3 * math.pi, -1e-7, 1e-7, -7.5],
    ]).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jtypes.angle_normalize(jnp.asarray(x)))
    got = ttypes.angle_normalize(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -math.pi and got.max() < math.pi + 1e-6


@pytest.mark.parametrize("model", MODEL_NAMES)
def test_make_spec_matches_for_every_model(model):
    _fields_equal(tspec.make_spec(model), jspec.make_spec(model))


def test_make_spec_override_rules():
    """DI's a_max sets ax/ay; the KB family derives beta_max from the steering."""
    cases = [
        (jspec.DOUBLE_INTEGRATOR_2D, dict(a_max=2.5)),
        (jspec.DOUBLE_INTEGRATOR_2D, dict(a_max=2.5, ax_max=0.7)),
        (jspec.KINEMATIC_BICYCLE_2D, dict(delta_max=0.3, wheel_base=0.6)),
        (jspec.KINEMATIC_BICYCLE_2D_DPCBF, dict(rear_ax_dist=0.1)),
        (jspec.DYNAMIC_UNICYCLE_2D, dict(a_max=1.0, w_max=0.5, not_a_field=3.0)),
    ]
    for model, kw in cases:
        _fields_equal(tspec.make_spec(model, **kw), jspec.make_spec(model, **kw))
    s = tspec.make_spec(jspec.DYNAMIC_UNICYCLE_2D)
    assert s.replace(radius=0.5).radius == 0.5 and s.radius == 0.25


def test_spec_config_and_state_interop():
    js = jspec.make_spec(jspec.DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5, radius=0.3)
    ps = interop.spec_from_jax(js)
    _fields_equal(ps, js)
    assert ps == tspec.make_spec(jspec.DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5,
                                 radius=0.3)

    jcfg = jmpc.MPCConfig(horizon=8, num_obs=5, outer_iters=4, use_fused_kernel=True)
    pcfg = interop.config_from_jax(jcfg)
    assert tuple(pcfg) == tuple(jcfg)
    assert pcfg._fields == jcfg._fields

    U = np.random.default_rng(0).normal(size=(3, 8, 2))
    st = interop.state_from_numpy(U, np.zeros((3, 56)), device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(st.U.numpy(), U)
    assert st.lam.shape == (3, 56) and st.U.dtype == torch.float64
