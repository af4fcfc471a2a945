"""Vision/DVS sensors: geometry vs the reference cv2 pipeline + wrappers."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_copter_tpu.sensors.vision import DVS, VisionSensor
from gym_copter_tpu.envs.visual import VisualCopterEnv
import gym_copter_tpu as gct

REF_VS = '/root/reference/attic/gym_copter/sensors/vision/vs.py'


def load_reference_sensor():
    spec = importlib.util.spec_from_file_location('refvs', REF_VS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.VisionSensor


@pytest.mark.skipif(not os.path.exists(REF_VS),
                    reason='reference checkout not available')
@pytest.mark.parametrize('res', [16, 64])
def test_matches_reference_cv2_pipeline(res):
    """The analytic inverse-warp must agree with the reference's
    cv2.warpPerspective pipeline except for rasterization edge pixels
    (>=96% pixel agreement across random poses)."""
    try:
        RefSensor = load_reference_sensor()
    except ImportError:
        pytest.skip('cv2 not available')
    ref = RefSensor(res=res)
    ours = VisionSensor(res=res)
    rng = np.random.default_rng(0)
    for _ in range(8):
        x, y = rng.uniform(-3, 3, 2)
        z = rng.uniform(2, 10)
        phi, theta, psi = rng.uniform(-20, 20, 3)
        ri = ref.getImage(x, y, z, phi, theta, psi)
        oi = np.asarray(ours.get_image(x, y, z, phi, theta, psi))
        assert ri.shape == oi.shape
        assert (ri == oi).mean() >= 0.96


def test_basic_geometry():
    """Straight-down view: pad centered, radius shrinks with altitude."""
    s = VisionSensor(res=64)
    low = np.asarray(s.get_image(0, 0, 2, 0, 0, 0))
    high = np.asarray(s.get_image(0, 0, 8, 0, 0, 0))
    assert low.sum() > high.sum() > 0
    # centered: symmetric about the middle
    assert low[32, 32] == 1.0
    off = np.asarray(s.get_image(3, 0, 2, 0, 0, 0))
    # pad offset in +x moves the circle along the column axis
    assert off[32, 32] == 0.0 or off.sum() < low.sum()


def test_batched_images_match_single():
    s = VisionSensor(res=16)
    rng = np.random.default_rng(1)
    poses = np.zeros((6, 5))
    poses[0:2] = rng.uniform(-2, 2, (2, 5))
    poses[2] = rng.uniform(2, 8, 5)
    poses[3:6] = rng.uniform(-15, 15, (3, 5))
    batch = np.asarray(s.get_images(jnp.asarray(poses, jnp.float32)))
    for i in range(5):
        single = np.asarray(s.get_image(*poses[:, i]))
        np.testing.assert_array_equal(batch[i], single)


def test_dvs_first_frame_zero_then_signed_diff():
    env = gct.make('Hover3D-v0', num_envs=3, seed=0)
    venv = VisualCopterEnv(env, dvs=True)
    state, obs = venv.reset()
    # motors off: the copter free-falls, the pad grows rapidly in view, so
    # consecutive frames differ
    a = jnp.zeros((4, 3), jnp.float32)
    state, ts, ev0 = venv.step(state, a)
    np.testing.assert_array_equal(np.asarray(ev0), 0.0)  # first call: zeros
    ev_any = 0.0
    for _ in range(120):
        state, ts, ev = venv.step(state, a)
        ev_any += np.abs(np.asarray(ev)).sum()
    ev = np.asarray(ev)
    assert set(np.unique(ev)).issubset({-1.0, 0.0, 1.0})
    assert ev_any > 0  # motion produced events somewhere in the window


def test_visual_wrapper_shapes():
    env = gct.make('Lander3D-v0', num_envs=4, seed=0)
    venv = VisualCopterEnv(env)
    state, obs = venv.reset()
    a = jnp.full((4, 4), 1.625e-2, jnp.float32)
    state, ts, img = venv.step(state, a)
    assert img.shape == (4, 16, 16)
    assert set(np.unique(np.asarray(img))).issubset({0.0, 1.0})


def test_closed_form_homography_matches_four_point_solve():
    """The closed-form projective matrix must equal the matrix recovered
    from the 4 warped corner correspondences (the reference's
    cv2.getPerspectiveTransform construction, vs.py:117-199) — the
    8x8-solve oracle is reproduced here in numpy float64."""
    s = VisionSensor(res=32)
    rng = np.random.RandomState(3)
    for _ in range(25):
        psi, theta, phi = rng.uniform(-40, 40, 3)
        hmat = np.asarray(s._warp_homography(
            jnp.float32(psi), jnp.float32(theta), jnp.float32(phi)))

        # oracle: build fmat = P @ T @ Rtheta @ Rpsi @ Rphi in float64,
        # warp the 4 corners, solve the 8x8 correspondence system
        def rot(a):
            return np.radians(a)
        st, ct = np.sin(rot(psi)), np.cos(rot(psi))
        sp, cp = np.sin(rot(theta)), np.cos(rot(theta))
        sg, cg = np.sin(rot(phi)), np.cos(rot(phi))
        r_psi = np.array([[ct, -st, 0, 0], [st, ct, 0, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1.0]])
        r_theta = np.array([[1, 0, 0, 0], [0, cp, -sp, 0],
                            [0, sp, cp, 0], [0, 0, 0, 1.0]])
        r_phi = np.array([[cg, 0, -sg, 0], [0, 1, 0, 0],
                          [sg, 0, cg, 0], [0, 0, 0, 1.0]])
        half_fov = np.radians(s.fov / 2)
        t = np.eye(4); t[2, 3] = -s.h
        p = np.zeros((4, 4))
        p[0, 0] = p[1, 1] = 1.0 / np.tan(half_fov)
        p[2, 2] = -(s.f + s.n) / (s.f - s.n)
        p[2, 3] = -(2.0 * s.f * s.n) / (s.f - s.n)
        p[3, 2] = -1.0
        fmat = p @ t @ r_theta @ r_psi @ r_phi
        hw = s.res / 2.0
        corners = np.array([[-hw, hw, hw, -hw], [hw, hw, -hw, -hw],
                            [0, 0, 0, 0], [1, 1, 1, 1.0]])
        out = fmat @ corners
        pts_out = (out[:2] / out[3] + 1.0) * (s.side_length_f * 0.5)
        pts_in = corners[:2] + hw
        rows, rhs = [], []
        for i in range(4):
            xi, yi = pts_in[0, i], pts_in[1, i]
            xo, yo = pts_out[0, i], pts_out[1, i]
            rows.append([xi, yi, 1, 0, 0, 0, -xo * xi, -xo * yi])
            rows.append([0, 0, 0, xi, yi, 1, -yo * xi, -yo * yi])
            rhs += [xo, yo]
        hvec = np.linalg.solve(np.array(rows), np.array(rhs))
        oracle = np.concatenate([hvec, [1.0]]).reshape(3, 3)
        np.testing.assert_allclose(hmat, oracle, rtol=2e-4, atol=2e-4)


def test_image_path_contains_no_serializing_linalg():
    """Performance guard: the batched image path must stay free of LU
    factorizations and loops — a batched 8x8 jnp.linalg.solve serializes
    inside lax.scan.  The closed-form construction is
    pure elementwise math, so the jaxpr must contain no while/scan, no
    triangular_solve, and no lu."""
    s = VisionSensor(res=16)
    poses = jnp.zeros((6, 8), jnp.float32).at[2].set(5.0)
    jaxpr = str(jax.make_jaxpr(s.get_images)(poses))
    for banned in ('triangular_solve', ' lu ', 'lu[', 'while', 'scan'):
        assert banned not in jaxpr, f'{banned!r} found in image jaxpr'
