"""Port parity: perception (``perception/grid.py`` and ``perception/fov.py``).

The port's batched functions against ``jax.vmap`` of the JAX package's on
the same numpy inputs (seeded poses and obstacles), in float32:

- the footprint masks (initial disk, FoV sector, its OR-update, segment
  tubes, the integrator and decelerating-arc safety areas) and
  ``is_beyond_footprint`` in both modes: equal element for element;
- the decelerating-arc points: within 1e-5;
- FoV detection, ``is_in_fov`` and ray detection through a footprint:
  detection flags equal, detected rows within 1e-5;
- ``merge_memory`` over a sequence of calls with repeated detections,
  near-duplicates within the merge tolerances and more new obstacles than
  free slots (a full memory): slots and valid flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core.spec import DOUBLE_INTEGRATOR_2D, make_spec
from safe_control_tpu.core.types import pad_obstacles as jpad
from safe_control_tpu.perception import fov as jfov
from safe_control_tpu.perception import grid as jgrid
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.perception import fov as tfov
from safe_control_tpu_torch.perception import grid as tgrid

torch.set_num_threads(1)

B = 6
DT = 0.05
JGS = jgrid.GridSpec(width=20.0, height=20.0, resolution=0.1)
TGS = interop.grid_from_jax(JGS)
SPEC = make_spec(DOUBLE_INTEGRATOR_2D, cam_range=2.97)
TSPEC = interop.spec_from_jax(SPEC)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def poses(seed=0):
    """Positions off the cell lattice inside the grid, and yaws."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(3.0, 17.0, (B, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    return pos, yaw


def _footprint(pos, yaw):
    """A footprint grown over three poses of each robot (JAX's update)."""
    fp = jax.vmap(lambda p: jgrid.init_footprint(JGS, p, SPEC))(jnp.asarray(pos))
    for k in range(3):
        p = jnp.asarray(pos + 0.4 * k)
        fp = jax.vmap(lambda f, pp, yy: jgrid.update_footprint(f, JGS, pp, yy, SPEC))(
            fp, p, jnp.asarray(yaw + 0.3 * k))
    return np.array(fp)


def test_grid_spec_and_cell_centers():
    assert (TGS.nx, TGS.ny) == (JGS.nx, JGS.ny) == (200, 200)
    cx, cy = tgrid.cell_centers(TGS)
    jx, jy = jgrid.cell_centers(JGS)
    assert np.array_equal(cx.numpy(), np.asarray(jx)) and np.array_equal(cy.numpy(), np.asarray(jy))


def test_footprint_masks_equal_jax():
    pos, yaw = poses()
    jp, jy = jnp.asarray(pos), jnp.asarray(yaw)
    tp, ty = _t(pos), _t(yaw)
    want = np.asarray(jax.vmap(lambda p: jgrid.init_footprint(JGS, p, SPEC))(jp))
    got = tgrid.init_footprint(TGS, tp, TSPEC).numpy()
    assert np.array_equal(got, want) and got.any()
    want = np.asarray(jax.vmap(lambda p, y: jgrid.fov_mask(JGS, p, y, SPEC))(jp, jy))
    got = tgrid.fov_mask(TGS, tp, ty, TSPEC).numpy()
    assert np.array_equal(got, want) and got.sum() > 1000
    fp = _footprint(pos, yaw)
    want = np.asarray(jax.vmap(lambda f, p, y: jgrid.update_footprint(f, JGS, p, y, SPEC))(
        jnp.asarray(fp), jp + 1.0, jy - 0.5))
    got = tgrid.update_footprint(torch.as_tensor(fp), TGS, tp + 1.0, ty - 0.5, TSPEC).numpy()
    assert np.array_equal(got, want)


def test_segment_tube_and_safety_areas_equal_jax():
    pos, yaw = poses(1)
    rng = np.random.default_rng(5)
    vel = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
    vel[0] = 0.0  # standing still: the tube follows the yaw
    p1 = pos + rng.uniform(-2, 2, (B, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a, b: jgrid.segment_tube_mask(JGS, a, b, 0.25))(
        jnp.asarray(pos), jnp.asarray(p1)))
    got = tgrid.segment_tube_mask(TGS, _t(pos), _t(p1), 0.25).numpy()
    assert np.array_equal(got, want) and got.any()

    want = np.asarray(jax.vmap(lambda p, y, v: jgrid.safety_area_mask(
        JGS, p, y, 0.0, 0.0, SPEC, DT, max_decel=3.0, integrator=True, vel=v))(
        jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(vel)))
    got = tgrid.safety_area_mask(TGS, _t(pos), _t(yaw), None, None, TSPEC, DT, max_decel=3.0,
                                 integrator=True, vel=_t(vel)).numpy()
    assert np.array_equal(got, want)

    speed = rng.uniform(0.2, 1.5, B).astype(np.float32)
    rate = rng.uniform(-1.0, 1.0, B).astype(np.float32)
    rate[0] = 0.0
    want_pts = np.asarray(jax.vmap(lambda p, y, v, w: jgrid.braking_arc_points(
        p, y, v, w, SPEC, DT, 3.0, 3.0))(jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(speed),
                                        jnp.asarray(rate)))
    got_pts = tgrid.braking_arc_points(_t(pos), _t(yaw), _t(speed), _t(rate), TSPEC, DT, 3.0,
                                       3.0).numpy()
    assert got_pts.shape == want_pts.shape == (B, 33, 2)
    np.testing.assert_allclose(got_pts, want_pts, atol=1e-5)
    want = np.asarray(jax.vmap(lambda p, y, v, w: jgrid.safety_area_mask(
        JGS, p, y, v, w, SPEC, DT, max_decel=3.0, max_ang_decel=3.0))(
        jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(speed), jnp.asarray(rate)))
    got = tgrid.safety_area_mask(TGS, _t(pos), _t(yaw), _t(speed), _t(rate), TSPEC, DT,
                                 max_decel=3.0, max_ang_decel=3.0).numpy()
    assert np.array_equal(got, want) and got.any()


@pytest.mark.parametrize("mode", ["point_mass", "safety_area"])
def test_is_beyond_footprint_equal_jax(mode):
    pos, yaw = poses(2)
    fp = _footprint(pos, yaw)
    # robots near, at and far from their known region, and one off the grid
    probe = pos + np.array([[0.1, 0.0], [1.5, 0.4], [-2.5, 1.0], [0.0, 0.0], [6.0, -6.0],
                            [30.0, -4.0]], np.float32)
    if mode == "point_mass":
        want = np.asarray(jax.vmap(lambda f, p: jgrid.is_beyond_footprint(f, JGS, p))(
            jnp.asarray(fp), jnp.asarray(probe)))
        got = tgrid.is_beyond_footprint(torch.as_tensor(fp), TGS, _t(probe)).numpy()
    else:
        tube = jax.vmap(lambda p, y: jgrid.fov_mask(JGS, p, y, SPEC))(
            jnp.asarray(probe), jnp.asarray(yaw))
        want = np.asarray(jax.vmap(lambda f, p, s: jgrid.is_beyond_footprint(
            f, JGS, p, safety_mask=s))(jnp.asarray(fp), jnp.asarray(probe), tube))
        got = tgrid.is_beyond_footprint(torch.as_tensor(fp), TGS, _t(probe),
                                        safety_mask=torch.as_tensor(np.asarray(tube))).numpy()
    assert np.array_equal(got, want) and got.any() and not got.all()


def unknown_obstacles(seed=3, n=9, pad=12):
    """Circles and superellipsoids scattered around the robots."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        x, y = rng.uniform(2.0, 18.0, 2)
        if i % 3 == 2:
            rows.append([x, y, rng.uniform(0.3, 0.8), rng.uniform(0.2, 0.6), 4.0,
                         rng.uniform(-1, 1), 1.0])
        else:
            rows.append([x, y, rng.uniform(0.2, 0.9), 0, 0, 0, 0])
    return np.asarray(jpad(jnp.asarray(rows, jnp.float32), pad))


def test_fov_detection_equal_jax():
    pos, yaw = poses(4)
    obs = unknown_obstacles()
    # put one obstacle in front of each robot, so that every robot detects one
    ahead = pos + 2.0 * np.stack([np.cos(yaw), np.sin(yaw)], 1)
    obs_b = np.tile(obs[None], (B, 1, 1))
    obs_b[np.arange(B), np.arange(B) % 9, :2] = ahead
    jdet, jmask = jax.vmap(lambda p, y, o: jfov.detect_unknown_obs_fov(p, y, o, SPEC))(
        jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(obs_b))
    tdet, tmask = tfov.detect_unknown_obs_fov(_t(pos), _t(yaw), _t(obs_b), TSPEC)
    assert np.array_equal(tmask.numpy(), np.asarray(jmask)) and tmask.all(-1).sum() < B
    assert tmask.any(-1).all()
    np.testing.assert_allclose(tdet.numpy(), np.asarray(jdet), atol=1e-5)
    pts = obs_b[..., :2]
    for check_range in (False, True):
        want = np.asarray(jax.vmap(lambda p, y, q: jax.vmap(lambda qq: jfov.is_in_fov(
            p, y, qq, SPEC, check_range=check_range))(q))(
            jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(pts)))
        got = tfov.is_in_fov(_t(pos)[:, None], _t(yaw)[:, None], _t(pts), TSPEC,
                             check_range=check_range).numpy()
        assert np.array_equal(got, want)


def test_ray_detection_equal_jax():
    pos, yaw = poses(6)
    fp = _footprint(pos, yaw)
    obs = np.tile(unknown_obstacles(seed=7)[None], (B, 1, 1))
    # one obstacle straddling the edge of each robot's first view
    obs[:, 0, :3] = np.concatenate([pos + 2.8 * np.stack([np.cos(yaw), np.sin(yaw)], 1),
                                    np.full((B, 1), 0.6)], 1)
    jdet, jmask = jax.vmap(lambda p, o, f: jfov.detect_unknown_obs_ray(p, o, f, JGS))(
        jnp.asarray(pos), jnp.asarray(obs), jnp.asarray(fp))
    tdet, tmask = tfov.detect_unknown_obs_ray(_t(pos), _t(obs), torch.as_tensor(fp), TGS)
    assert np.array_equal(tmask.numpy(), np.asarray(jmask)) and tmask.any()
    np.testing.assert_allclose(tdet.numpy(), np.asarray(jdet), atol=1e-5)


def test_merge_memory_equal_jax():
    """Four calls into a 5-slot memory: repeats of rows already stored,
    near-duplicates inside the tolerances, a near-miss outside them, and
    more new obstacles than free slots."""
    M = 5
    base = np.array([[1.0, 1.0, 0.5, 0, 0, 0, 0], [3.0, 1.0, 0.4, 0, 0, 0, 0],
                     [5.0, 2.0, 0.6, 0, 0, 0, 0], [7.0, 3.0, 0.3, 0, 0, 0, 0],
                     [9.0, 4.0, 0.7, 0, 0, 0, 0], [2.0, 6.0, 0.5, 0, 0, 0, 0],
                     [4.0, 7.0, 0.45, 0, 0, 0, 0]], np.float32)
    near = base[0] + np.array([5e-4, 0, 5e-3, 0, 0, 0, 0], np.float32)  # merges with row 0
    miss = base[1] + np.array([0, 0, 5e-2, 0, 0, 0, 0], np.float32)  # radius beyond tol
    calls = [
        (np.stack([base[0], base[1], base[0], base[2]]), [True, True, True, False]),
        (np.stack([near, miss, base[3], base[1]]), [True, True, True, True]),
        (np.stack([base[4], base[5], base[6], base[2]]), [True, True, True, True]),
        (np.stack([base[6], base[0], base[5], near]), [True, False, True, True]),
    ]
    # robot b sees the detections rolled by b, so the batch runs apart
    jmem = jax.vmap(lambda _: jfov.init_memory(M))(jnp.arange(B))
    tmem = tfov.init_memory(M, B)
    for det, mask in calls:
        det_b = np.stack([np.roll(det, b, axis=0) for b in range(B)])
        mask_b = np.stack([np.roll(np.asarray(mask), b) for b in range(B)])
        jmem = jax.vmap(jfov.merge_memory)(jmem, jnp.asarray(det_b), jnp.asarray(mask_b))
        tmem = tfov.merge_memory(tmem, _t(det_b), torch.as_tensor(mask_b))
        assert np.array_equal(tmem.valid.numpy(), np.asarray(jmem.valid))
        assert np.array_equal(tmem.slots.numpy(), np.asarray(jmem.slots))
    assert tmem.valid.all()  # the memory filled up and dropped the rest
