"""Synthetic downward-looking vision and DVS (event-camera) sensors.

Capability twin of the reference sensors (attic/gym_copter/sensors/vision/
vs.py, dvs.py), redesigned for batched execution:

  * the reference rasterizes the landing-pad circle with cv2.circle and
    perspective-warps the *image* with cv2.warpPerspective (vs.py:39-65,
    117-199); here the warp is inverted analytically, so each output pixel
    evaluates the circle predicate directly at its inverse-mapped source
    coordinate — no image gather, no OpenCV, pure elementwise math that
    vmaps over thousands of environments;
  * geometry matches the reference: pin-hole scaling by altitude
    (vs.py:109-115: pixel = coord * res / (2 z tan(fov/2)), truncated), the
    P*T*Rtheta*Rpsi*Rphi 4x4 projective chain (vs.py:117-176), the 4-point
    homography, the warp margin crop (vs.py:59-65), and binary
    re-thresholding;
  * DVS: first difference of consecutive frames quantized to {-1, 0, +1}
    (dvs.py:37-52) — the previous frame is carried functionally.

Images are (res, res) for one pose, (B, res, res) batched.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _adjugate3(m):
    """Adjugate of a 3x3 matrix: inv(m) * det(m), elementwise cofactors."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    return jnp.stack([
        jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e]),
        jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f]),
        jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d]),
    ])


class VisionSensor:
    """Functional vision sensor; all methods are jit/vmap-safe."""

    def __init__(self, objsize: float = 1.0, res: int = 128,
                 fov: float = 60.0):
        self.objsize = objsize
        self.res = res
        self.fov = fov

        # static warp-frame geometry (vs.py:50-53, 126-131)
        d = math.hypot(res, res)
        half_fov = math.radians(fov / 2)
        self.side_length = int(d / math.cos(half_fov))
        self.side_length_f = d / math.cos(half_fov)
        self.h = d / (2.0 * math.sin(half_fov))
        self.n = self.h - d / 2.0
        self.f = self.h + d / 2.0
        self.margin = (self.side_length - res) // 2

    # -- homography ---------------------------------------------------------

    def _warp_homography(self, psi, theta, phi):
        """3x3 output<-input pixel homography of the reference's
        cv2.getPerspectiveTransform(ptsIn, ptsOut) (vs.py:117-199), built
        from the same P*T*Rtheta*Rpsi*Rphi chain.  Angles in degrees.

        The reference recovers the matrix numerically from 4 warped corner
        points because that is OpenCV's API; the underlying map is already
        projective, so the matrix has a closed form.  With R = Rtheta @
        Rpsi @ Rphi, k = 1/tan(fov/2), s the warp-frame side length, and
        image z = 0, the 4x4 chain collapses to rows (x, y, 1) ->

            w' = -R20 x - R21 y + h                      (depth)
            u' = (s/2) ((k R00 - R20) x + (k R01 - R21) y + h)
            v' = (s/2) ((k R10 - R20) x + (k R11 - R21) y + h)

        composed with the corner shift (xi, yi) -> (xi - res/2, yi - res/2).
        Closed form keeps the per-env camera elementwise: a batched 8x8
        `jnp.linalg.solve` inside the `lax.scan` rollout would pivot each
        tiny LU serially, where these trig products vectorize over the
        batch like the physics step.
        """
        rad = jnp.radians
        st, ct = jnp.sin(rad(psi)), jnp.cos(rad(psi))
        sp, cp = jnp.sin(rad(theta)), jnp.cos(rad(theta))
        sg, cg = jnp.sin(rad(phi)), jnp.cos(rad(phi))

        # needed entries of R = r_theta @ r_psi @ r_phi (z=0 kills col 2)
        r00 = ct * cg
        r01 = -st
        r10 = cp * st * cg - sp * sg
        r11 = cp * ct
        r20 = sp * st * cg + cp * sg
        r21 = sp * ct

        half_fov = math.radians(self.fov / 2)
        k = 1.0 / math.tan(half_fov)
        s2 = self.side_length_f * 0.5
        h = self.h
        hw = self.res / 2.0

        # rows over centered coords (x, y, 1)
        a0 = s2 * (k * r00 - r20)
        a1 = s2 * (k * r01 - r21)
        a2 = jnp.full_like(st, s2 * h)
        b0 = s2 * (k * r10 - r20)
        b1 = s2 * (k * r11 - r21)
        b2 = a2
        c0 = -r20
        c1 = -r21
        c2 = jnp.full_like(st, h)

        # compose the (xi, yi) -> (xi - hw, yi - hw) shift, then normalize
        # to H[2,2] = 1 (the 8-parameter form the solve produced)
        det = c2 - hw * c0 - hw * c1
        hmat = jnp.stack([
            jnp.stack([a0, a1, a2 - hw * a0 - hw * a1]),
            jnp.stack([b0, b1, b2 - hw * b0 - hw * b1]),
            jnp.stack([c0, c1, det]),
        ]) / det
        return hmat

    # -- rendering ----------------------------------------------------------

    def _scale(self, z, val):
        """Altitude-scaled pin-hole projection, truncated to int like the
        reference (vs.py:109-115)."""
        half_fov = math.radians(self.fov / 2)
        return jnp.trunc(val * self.res / (2.0 * z * math.tan(half_fov)))

    def get_image(self, x, y, z, phi, theta, psi):
        """Render one pose -> (res, res) binary image.  Angles in DEGREES,
        z is positive altitude (the callers negate NED z, e.g.
        attic/gym_copter/envs/lander.py:118)."""
        x = jnp.asarray(x, jnp.float32)
        y = jnp.asarray(y, jnp.float32)
        z = jnp.asarray(z, jnp.float32)
        cx = self._scale(z, x) + self.res // 2
        cy = self._scale(z, y) + self.res // 2
        r = self._scale(z, jnp.asarray(self.objsize, jnp.float32))

        hmat = self._warp_homography(jnp.asarray(psi, jnp.float32),
                                     jnp.asarray(theta, jnp.float32),
                                     jnp.asarray(phi, jnp.float32))
        # adjugate inverse: hinv is only ever used through the projective
        # ratios u = row0.p / row2.p, so the 1/det scale cancels — no
        # linalg.inv (which, like the solve above, serializes in scans)
        hinv = _adjugate3(hmat)

        # output grid = cropped warp region (warped[margin:-margin])
        rows = jax.lax.broadcasted_iota(jnp.float32,
                                        (self.res, self.res), 0) + self.margin
        cols = jax.lax.broadcasted_iota(jnp.float32,
                                        (self.res, self.res), 1) + self.margin
        w = hinv[2, 0] * cols + hinv[2, 1] * rows + hinv[2, 2]
        u = (hinv[0, 0] * cols + hinv[0, 1] * rows + hinv[0, 2]) / w
        v = (hinv[1, 0] * cols + hinv[1, 1] * rows + hinv[1, 2]) / w

        # evaluate the filled-circle predicate at the source coordinate
        inside = ((u - cx) ** 2 + (v - cy) ** 2) <= r * r
        in_bounds = ((u >= 0) & (u <= self.res - 1)
                     & (v >= 0) & (v <= self.res - 1))
        return (inside & in_bounds).astype(jnp.float32)

    def get_images(self, poses):
        """Batched render: poses (6, B) rows (x, y, z, phi, theta, psi),
        angles in degrees, z positive altitude -> (B, res, res)."""
        return jax.vmap(
            lambda p: self.get_image(p[0], p[1], p[2], p[3], p[4], p[5]),
            in_axes=1)(poses)

    def pose_from_state(self, x):
        """(12, B) NED state -> (6, B) sensor pose: positive altitude
        clamped away from zero, angles to degrees (the wrappers'
        max(-z, 1e-6) + degrees() convention, hover3d.py:69-76)."""
        alt = jnp.maximum(-x[4], 1e-6)
        deg = jnp.degrees
        return jnp.stack([x[0], x[2], alt, deg(x[6]), deg(x[8]), deg(x[10])])


class DVS(VisionSensor):
    """Event camera: sign of the first difference of consecutive frames
    (dvs.py:37-52).  Functional: thread `prev` through the rollout."""

    def initial_prev(self, batch=None):
        shape = (self.res, self.res) if batch is None else (batch, self.res,
                                                            self.res)
        return jnp.zeros(shape, jnp.float32)

    def get_events(self, prev, x, y, z, phi, theta, psi):
        """Returns (events in {-1,0,+1}, new_prev)."""
        curr = self.get_image(x, y, z, phi, theta, psi)
        return jnp.sign(prev - curr), curr

    def get_events_batch(self, prev, poses):
        curr = self.get_images(poses)
        return jnp.sign(prev - curr), curr
