"""Batched Bouabdallah-2004 quad-X rigid-body dynamics.

Pure-functional, branchless reimplementation of the reference dynamics
(gym_copter/dynamics/__init__.py:114-197).  Where the reference mutates a
single 12-float numpy state behind three data-dependent `if` branches and an
early `return`, this step is one straight-line XLA program over masked
`jnp.where` updates, so thousands of vehicles integrate in lockstep under
`jit`.

Layout convention: the state `x` has shape (12,) for a single vehicle or
(12, B) for a batch ("struct of arrays") — every per-component operation is
then an elementwise op over a contiguous batch row, with no gathers.  All
functions below are polymorphic over these two layouts; masks of shape ()
or (B,) broadcast correctly against (12, B).

Semantics preserved exactly (see SURVEY.md §2.4 "parity traps"):
  * forward-Euler integration, one step per call (reference :187);
  * Eq.6 motor mixing with the ArduPilot quad-X layout (:231-247);
  * Eq.12 attitude accelerations including the fully-negated theta-ddot
    line (:281-284) and phi-ddot's precedence quirk (:275-277);
  * only the body-Z column rotated into the inertial frame, negated for
    NED (:292-302); netz = accelNED[2] + G (:143);
  * ground-contact state machine LANDED->AIRBORNE->{CRASHED|LEVELING}->LANDED
    (:147-177), including: a vehicle promoted LANDED->AIRBORNE integrates on
    the same call (`elif` on the *updated* status); touchdown returns early
    WITHOUT integrating, WITHOUT clearing the perturbation, and WITHOUT
    advancing the clock (:177 precedes :194,:197);
  * the perturbation double-count: `_computeStateDerivative` adds perturb
    into every velocity-derivative slot (:263-290) and `setMotors` adds it
    again via `_dxdt[1::2] += perturb` (:183), so each active perturbation
    is applied twice; it is cleared at the end of a non-early-return call
    (:194).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from gym_copter_tpu.core import constants as C
from gym_copter_tpu.core.types import VehicleParams, WorldParams


class DynamicsState(NamedTuple):
    """Carried dynamics state for one vehicle or a batch of vehicles.

    x:       (12,) or (12, B) state vector(s), NED frame
    status:  () or (B,) int32 flight status (constants.STATUS_*)
    perturb: (6,) or (6, B) pending acceleration perturbation (force / M),
             applied on the next integrating step (reference
             gym_copter/dynamics/__init__.py:227-229)
    ticks:   () or (B,) int32 step counter; time = ticks * dt (:219-221)
    """

    x: jnp.ndarray
    status: jnp.ndarray
    perturb: jnp.ndarray
    ticks: jnp.ndarray


def init_state(x, dtype=jnp.float32):
    """Create a DynamicsState from a state vector, reproducing
    `Dynamics.setState` (reference :210-217): airborne iff z < 0 (NED)."""
    x = jnp.asarray(x, dtype=dtype)
    z = x[C.STATE_Z]
    status = jnp.where(z < 0, C.STATUS_AIRBORNE, C.STATUS_LANDED)
    status = status.astype(jnp.int32)
    zeros6 = jnp.zeros((6,) + x.shape[1:], dtype=dtype)
    ticks = jnp.zeros(x.shape[1:], dtype=jnp.int32)
    return DynamicsState(x=x, status=status, perturb=zeros6, ticks=ticks)


def body_z_to_inertial(body_z, phi, theta, psi):
    """Rotate a body-Z-aligned vector into the inertial frame — the rightmost
    column of the body-to-inertial rotation matrix (reference :292-302)."""
    cph, sph = jnp.cos(phi), jnp.sin(phi)
    cth, sth = jnp.cos(theta), jnp.sin(theta)
    cps, sps = jnp.cos(psi), jnp.sin(psi)
    rx = sph * sps + cph * cps * sth
    ry = cph * sps * sth - cps * sph
    rz = cph * cth
    return body_z * rx, body_z * ry, body_z * rz


def step(
    state: DynamicsState,
    motorvals: jnp.ndarray,
    vp: VehicleParams,
    world: WorldParams,
    dt: float,
    lift_model: str = 'bouabdallah',
) -> DynamicsState:
    """One forward-Euler physics step == one `Dynamics.setMotors` call.

    motorvals: (4,) or (4, B) motor values in [0, 1].
    lift_model: 'bouabdallah' (active dynamics) or 'blade_element' (the
    attic mars variant — see EnvParams.lift_model).
    Returns the updated DynamicsState.  Fully branchless; safe under jit,
    vmap, scan, and shard_map.
    """
    x = state.x
    status = state.status
    perturb = state.perturb
    dtype = x.dtype
    g = jnp.asarray(world.g, dtype)

    # --- Eq. 6: motor speeds -> thrust + torques (reference :120-132) ---
    # association matches the reference expression ((m*maxrpm)*pi)/30 so
    # float64 trajectories agree to the last bit in non-chaotic regimes
    omegas = motorvals * vp.maxrpm * math.pi / 30.0
    o2 = omegas * omegas
    if lift_model == 'blade_element':
        # attic mars variant (attic/mars/dynamics/__init__.py:135-164):
        # per-motor blade-element lift 0.5*rho*S*C_L*(w*L/2)^2 with
        # S=0.05*L*4; roll/pitch from the lift mix (no arm-length factor);
        # live rotor-disturbance term Omega = u4(omegas), unsquared (:145)
        velocity = omegas * (vp.L / 2.0)
        s_area = 0.05 * vp.L * 4.0
        lift = 0.5 * world.rho * s_area * vp.C_L * (velocity * velocity)
        U1 = lift[0] + lift[1] + lift[2] + lift[3]
        U2 = (lift[1] + lift[2]) - (lift[0] + lift[3])
        U3 = (lift[1] + lift[3]) - (lift[0] + lift[2])
        U4 = vp.D * ((o2[0] + o2[1]) - (o2[2] + o2[3]))
        Omega = (omegas[0] + omegas[1]) - (omegas[2] + omegas[3])
    else:
        U1 = vp.B * (o2[0] + o2[1] + o2[2] + o2[3])
        # quad-X ArduPilot mixing (reference :231-247)
        U2 = vp.L * vp.B * ((o2[1] + o2[2]) - (o2[0] + o2[3]))
        U3 = vp.L * vp.B * ((o2[1] + o2[3]) - (o2[0] + o2[2]))
        U4 = vp.D * ((o2[0] + o2[1]) - (o2[2] + o2[3]))
        # rotor disturbance term hardcoded zero in the reference (:134-135)
        Omega = None

    # --- thrust vector into inertial frame, NED (reference :137-143) ---
    phi, theta, psi = x[C.STATE_PHI], x[C.STATE_THETA], x[C.STATE_PSI]
    ax, ay, az = body_z_to_inertial(-U1 / vp.M, phi, theta, psi)
    netz = az + g

    # --- status machine, phase 1: LANDED -> AIRBORNE (reference :147-149) ---
    status1 = jnp.where(
        (status == C.STATUS_LANDED) & (netz < 0), C.STATUS_AIRBORNE, status
    )

    leveling = status1 == C.STATUS_LEVELING
    airborne = status1 == C.STATUS_AIRBORNE

    # --- touchdown / crash classification (reference :162-175).
    # The reference labels Y_DOT "velx" and Z_DOT "vely"; preserved.
    z, dz = x[C.STATE_Z], x[C.STATE_Z_DOT]
    dy = x[C.STATE_Y_DOT]
    touchdown = airborne & (z > 0) & (dz > 0)
    crash = (
        (dz > C.LANDING_VEL_Y)
        | (jnp.abs(dy) > C.LANDING_VEL_X)
        | (jnp.abs(phi) > C.LANDING_ANGLE)
    )
    integrate = airborne & ~touchdown

    # --- Eq. 12 state derivative (reference :249-290), perturbation included
    # once here and once more below — the reference's double-count quirk.
    phidot = x[C.STATE_PHI_DOT]
    thedot = x[C.STATE_THETA_DOT]
    psidot = x[C.STATE_PSI_DOT]
    if Omega is None:
        # Omega == 0: the Jr gyroscopic terms vanish (expressions kept
        # exactly as the active reference writes them, :275-290)
        phi_ddot = (psidot * thedot * (vp.Iy - vp.Iz) / vp.Ix
                    + U2 / vp.Ix + perturb[3])
        theta_ddot = (-(psidot * phidot * (vp.Iz - vp.Ix) / vp.Iy
                        + U3 / vp.Iy) + perturb[4])
    else:
        # attic mars Eq.12 with live Omega (attic :280-289), including the
        # same precedence quirks
        phi_ddot = (psidot * thedot * (vp.Iy - vp.Iz) / vp.Ix
                    - vp.Jr / vp.Ix * thedot * Omega
                    + U2 / vp.Ix + perturb[3])
        theta_ddot = (-(psidot * phidot * (vp.Iz - vp.Ix) / vp.Iy
                        + vp.Jr / vp.Iy * phidot * Omega
                        + U3 / vp.Iy) + perturb[4])
    dxdt = jnp.stack(
        [
            x[C.STATE_X_DOT],
            ax + perturb[0],
            x[C.STATE_Y_DOT],
            ay + perturb[1],
            x[C.STATE_Z_DOT],
            netz + perturb[2],
            phidot,
            phi_ddot,
            thedot,
            theta_ddot,
            psidot,
            thedot * phidot * (vp.Ix - vp.Iy) / vp.Iz + U4 / vp.Iz + perturb[5],
        ]
    )
    # second application of the perturbation to all six velocity slots
    # (reference :183, `_dxdt[1::2] += self._perturb`)
    dxdt = dxdt.at[1::2].add(perturb)

    x_integrated = x + dt * dxdt

    # leveling zeroes roll/pitch then lands (reference :152-156)
    zero = jnp.zeros_like(phi)
    x_leveled = x.at[C.STATE_PHI].set(zero).at[C.STATE_THETA].set(zero)

    x_out = jnp.where(integrate, x_integrated, jnp.where(leveling, x_leveled, x))

    status_out = jnp.where(
        leveling,
        C.STATUS_LANDED,
        jnp.where(
            touchdown,
            jnp.where(crash, C.STATUS_CRASHED, C.STATUS_LEVELING),
            status1,
        ),
    ).astype(jnp.int32)

    # early return on touchdown: perturbation survives, clock does not tick
    # (reference :177 vs :194,:197)
    perturb_out = jnp.where(touchdown, perturb, jnp.zeros_like(perturb))
    ticks_out = state.ticks + jnp.where(touchdown, 0, 1).astype(jnp.int32)

    return DynamicsState(x=x_out, status=status_out, perturb=perturb_out,
                         ticks=ticks_out)


def perturb(state: DynamicsState, force, vp: VehicleParams) -> DynamicsState:
    """Queue an instantaneous force perturbation (reference :227-229):
    stored as acceleration (force / M), consumed by the next step."""
    force = jnp.asarray(force, state.x.dtype)
    return state._replace(perturb=force / vp.M)


# ---------------------------------------------------------------------------
# Frame-conversion / accessor utility surface of the reference dynamics core
# (gym_copter/dynamics/__init__.py:199-221, 304-337).  Dead code in the
# reference's own env flow, but declared API of the dynamics class — provided
# here as batched pure functions: each angle argument is () or (B,), vectors
# are (3,) or (3, B), so whole env batches convert in one elementwise fuse.
# ---------------------------------------------------------------------------


def _sincos(phi, theta, psi):
    """cos/sin of the three Euler angles (reference `_sincos`, :339-350)."""
    return (jnp.cos(phi), jnp.cos(theta), jnp.cos(psi),
            jnp.sin(phi), jnp.sin(theta), jnp.sin(psi))


def inertial_to_body(inertial, phi, theta, psi):
    """Rotate an inertial-frame vector into the body frame
    (reference `_inertialToBody`, :304-312).  inertial: (3,) or (3, B)."""
    cph, cth, cps, sph, sth, sps = _sincos(phi, theta, psi)
    ix, iy, iz = inertial[0], inertial[1], inertial[2]
    bx = cps * cth * ix + cth * sps * iy - sth * iz
    by = ((cps * sph * sth - cph * sps) * ix
          + (cph * cps + sph * sps * sth) * iy + cth * sph * iz)
    bz = ((sph * sps + cph * cps * sth) * ix
          + (cph * sps * sth - cps * sph) * iy + cph * cth * iz)
    return jnp.stack([bx, by, bz])


def body_to_inertial(body, phi, theta, psi):
    """Rotate a body-frame vector into the inertial frame — transpose of
    `inertial_to_body` (reference `_bodyToInertial`, :314-328; see Section 5
    of chrobotics.com/library/understanding-euler-angles).
    body: (3,) or (3, B)."""
    cph, cth, cps, sph, sth, sps = _sincos(phi, theta, psi)
    bx, by, bz = body[0], body[1], body[2]
    ix = (cps * cth * bx + (cps * sph * sth - cph * sps) * by
          + (sph * sps + cph * cps * sth) * bz)
    iy = (cth * sps * bx + (cph * cps + sph * sps * sth) * by
          + (cph * sps * sth - cps * sph) * bz)
    iz = -sth * bx + cth * sph * by + cph * cth * bz
    return jnp.stack([ix, iy, iz])


def euler_to_quaternion(phi, theta, psi):
    """Euler angles -> quaternion (w, x, y, z), preserving the reference's
    exact half-angle expressions INCLUDING its sign conventions
    (`_eulerToQuaternion`, :330-337 — note the negated third component).
    Returns shape (4,) or (4, B)."""
    cph, cth, cps, sph, sth, sps = _sincos(phi / 2, theta / 2, psi / 2)
    return jnp.stack([
        cph * cth * cps + sph * sth * sps,
        cph * sth * sps - sph * cth * cps,
        -cph * sth * cps - sph * cth * sps,
        cph * cth * sps - sph * sth * cps,
    ])


def state_dict(state: DynamicsState):
    """The vehicle state as a {name: value} dict — `Dynamics.getState`
    (reference :199-207).  Values are () or (B,) arrays."""
    keys = ('x', 'dx', 'y', 'dy', 'z', 'dz',
            'phi', 'dphi', 'theta', 'dtheta', 'psi', 'dpsi')
    return {key: state.x[i] for i, key in enumerate(keys)}


def get_time(state: DynamicsState, dt: float):
    """Simulated time = ticks * dt — `Dynamics.getTime` (reference
    :219-221); touchdown steps do not advance the clock (:177)."""
    return state.ticks * dt
