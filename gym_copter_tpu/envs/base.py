"""Batched, pure-functional environment layer.

Reimplements the reference task layer (gym_copter/envs/task.py:77-197) as a
single branchless XLA program over a batch of environments.  Where the
reference holds one mutable env object and allocates a fresh `Dynamics` per
episode (task.py:161), here the whole environment state is a pytree of
(…, B)-shaped arrays and episode boundaries are handled by masked auto-reset
inside the same jitted step — no allocation, no host round-trip, no Python
in the hot loop.

Layout: "struct of arrays" — the 12-state is (12, B), actions are (A, B),
observations are (obs_dim, B) ("features-first").  Every per-env quantity is
a contiguous (B,) vector, so elementwise physics reads and writes whole rows,
and a features-first MLP policy computes W @ obs with B as the wide
dimension.

Determinism: each environment's randomness is derived as
`fold_in(fold_in(base_key, global_env_id), episode_index)`, so trajectories
are bit-identical regardless of batch size or sharding layout (SURVEY.md §7
"Multi-host determinism").
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from gym_copter_tpu.core import constants as C
from gym_copter_tpu.core import dynamics
from gym_copter_tpu.core.dynamics import DynamicsState
from gym_copter_tpu.core.types import EnvParams


class TaskSpec(NamedTuple):
    """Static (hashable) task description.

    kind:         'lander' (shaped reward + landing bonus + landed
                  termination, gym_copter/envs/lander.py:46-74), 'hover'
                  (+1 per surviving step, attic/gym_copter/envs/hover.py:18-21),
                  'althold' (+1 per step within tolerance of the target
                  altitude, attic/gym_copter/envs/althold.py:36-55),
                  'takeoff' (-|alt-target| shaping delta,
                  attic/gym_copter/envs/takeoff.py:83-87), 'distance'
                  (sqrt(x^2+y^2) shaping delta, attic distance.py:79-83),
                  or 'target' (15-dim obs with a circling target, reward
                  stubbed 0, attic target.py:44-51).
    obs_indices:  which of the 12 state slots form the observation
                  (1D: (z,dz); 2D: (y,dy,z,dz,phi,dphi); 3D lander drops
                  (psi,dpsi); hover3d keeps all 12 — SURVEY.md §2.4).
    mix_matrix:   (4, action_size) motor-mix rows, motors4 = mix @ action
                  (1D: broadcast, 2D: [m0,m1,m1,m0], 3D: identity —
                  attic lander1d.py:47-49, lander2d.py:49-51).
    action_mode:  'clip01' (clip to [0,1], task.py:91), 'rescale01'
                  ((1+a)/2, althold.py:38-42 / target.py:38-40), or 'raw'
                  (motor values passed straight through, takeoff.py:67).
    termination:  'standard' (oob/tilt/crash/landed, task.py:111-130),
                  'crash_only' (target.py:42), or 'none' (registry step cap
                  only, takeoff/distance/althold).
    skip_when_landed: the active task layer skips the dynamics once safely
                  landed (task.py:86-94); the aux tasks drive the dynamics
                  directly and must integrate from the ground up.
    start_altitude: overrides params.task.initial_altitude (aux tasks start
                  grounded at 0 or at the hold target).
    negate_obs:   observation negated into ENU (althold returns positive
                  altitude/climb-rate, althold.py:48-50).
    perturb_on_reset: the Lander/Hover random wind kick (task.py:177-188);
                  off for the aux tasks.
    """

    name: str
    kind: str
    obs_indices: Tuple[int, ...]
    action_size: int
    mix_matrix: Tuple[Tuple[float, ...], ...]
    action_mode: str = 'clip01'
    termination: str = 'standard'
    skip_when_landed: bool = True
    start_altitude: Optional[float] = None
    negate_obs: bool = False
    perturb_on_reset: bool = True
    # attic "simple" 3D lander extras (attic/gym_copter/envs/simple_lander3d.py):
    # fixed +offset start on X and Y (INITIAL_RANDOM_OFFSET=2.5 with the
    # randn factor commented out, :74-76), and a reset that is a REAL
    # zero-demand step — one dt of free fall before the first observation
    # (:79 `return self.step(np.array([-1, 0, 0]))[0]`).
    start_xy_offset: float = 0.0
    integrate_on_reset: bool = False

    @property
    def obs_size(self) -> int:
        return len(self.obs_indices) + (3 if self.kind == 'target' else 0)


class EnvState(NamedTuple):
    """Carried state for a batch of B environments (all arrays (…, B))."""

    dyn: DynamicsState          # x (12,B), status (B,), perturb (6,B), ticks (B,)
    prev_shaping: jnp.ndarray   # (B,) shaping value from the previous step
    steps: jnp.ndarray          # (B,) int32, counts the initializing step
    episode: jnp.ndarray        # (B,) int32 episode index (keys randomness)
    initial_random_x: jnp.ndarray  # (B,) sign of the Y-force (2D flag dir,
                                   # task.py:188 — which reads index 1)


class TimeStep(NamedTuple):
    """Step output. obs is features-first (obs_dim, B) and — following the
    standard JAX auto-reset convention — already belongs to the *new*
    episode on done steps; reward/done/x describe the finished step (x is
    the full pre-reset 12-state, for rendering and diagnostics)."""

    obs: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    status: jnp.ndarray
    spinning: jnp.ndarray
    x: jnp.ndarray


def _tree_where(cond, a, b):
    """Per-env select over matching pytrees; cond is (B,), leaves (…, B)."""
    return jax.tree.map(lambda u, v: jnp.where(cond, u, v), a, b)


def _shaping(x, params: EnvParams, spec: TaskSpec):
    """Per-kind shaping potential.  Lander: -(25·‖(x..dz)‖ + 50·‖(psi,dpsi)‖)
    minus 100 when |dz| exceeds 10 (gym_copter/envs/lander.py:52-56);
    takeoff: -|alt-target| (takeoff.py:83-87); distance: sqrt(x²+y²)
    (distance.py:79-83); other kinds carry no shaping."""
    dtype = x.dtype
    if spec.kind == 'lander':
        rp = params.reward
        pos = x[0:6]
        yaw = x[10:12]
        s = -(rp.xyz_penalty_factor * jnp.sqrt(jnp.sum(pos * pos, axis=0))
              + rp.yaw_penalty_factor * jnp.sqrt(jnp.sum(yaw * yaw, axis=0)))
        s = s - jnp.where(jnp.abs(x[C.STATE_Z_DOT]) > rp.dz_max,
                          jnp.asarray(rp.dz_penalty, dtype),
                          jnp.asarray(0.0, dtype))
        return s
    if spec.kind == 'lander_simple':
        # -(25·‖state[0:6]‖ + 250·‖state[6:10]‖): one penalty over position
        # AND velocity, a heavier one over roll/pitch angles and rates; no
        # dz-excess term and no yaw term (simple_lander3d.py:113-117)
        rp = params.reward
        pos = x[0:6]
        ang = x[6:10]
        return -(rp.xyz_penalty_factor * jnp.sqrt(jnp.sum(pos * pos, axis=0))
                 + rp.pitch_roll_penalty_factor
                 * jnp.sqrt(jnp.sum(ang * ang, axis=0)))

    if spec.kind == 'takeoff':
        altitude = -x[C.STATE_Z]
        return -jnp.abs(altitude - jnp.asarray(params.task.takeoff_target,
                                               dtype))
    if spec.kind == 'distance':
        return jnp.sqrt(x[C.STATE_X] ** 2 + x[C.STATE_Y] ** 2)
    return jnp.zeros(x.shape[1:], dtype)


def _reward(entry_status, x, prev_shaping, params: EnvParams, spec: TaskSpec):
    """Returns (reward, new_shaping, done_from_reward) for the task kind."""
    dtype = x.dtype
    zeros = jnp.zeros(x.shape[1:], dtype)
    no_done = jnp.zeros(x.shape[1:], bool)

    if spec.kind == 'hover':
        return jnp.ones(x.shape[1:], dtype), zeros, no_done

    if spec.kind == 'althold':
        # +1 per step within tolerance of the hold target (althold.py:52;
        # the reference returns the *cumulative* total each step — a gym-API
        # quirk; here the reward is the per-step increment)
        altitude = -x[C.STATE_Z]
        on_target = (jnp.abs(altitude - params.task.althold_target)
                     < params.task.althold_tolerance)
        return on_target.astype(dtype), zeros, no_done

    if spec.kind == 'target':
        return zeros, zeros, no_done  # reward stubbed 0 (target.py:50-51)

    if spec.kind in ('takeoff', 'distance'):
        shaping = _shaping(x, params, spec)
        return shaping - prev_shaping, shaping, no_done

    if spec.kind == 'lander_simple':
        # shaping delta only; the landing bonus is applied AFTER the
        # out-of-bounds/tilt replacement, matching the simple task's step
        # order (simple_lander3d.py:121-141) — unlike the active task,
        # where the bonus precedes the replacement (task.py:102-118).
        # The episode ends the moment the vehicle is landed.
        shaping = _shaping(x, params, spec)
        landed = entry_status == C.STATUS_LANDED
        return shaping - prev_shaping, shaping, landed

    rp = params.reward
    shaping = _shaping(x, params, spec)
    reward = shaping - prev_shaping
    landed = entry_status == C.STATUS_LANDED
    inside = jnp.sqrt(x[C.STATE_X] ** 2 + x[C.STATE_Y] ** 2) < rp.target_radius
    reward = reward + jnp.where(landed & inside,
                                jnp.asarray(rp.inside_radius_bonus, dtype),
                                jnp.asarray(0.0, dtype))
    return reward, shaping, landed


def _get_obs(x, steps, params: EnvParams, spec: TaskSpec):
    """Observation extraction: static row slice of the (12, B) state, with
    optional ENU negation (althold.py:48-50) and the circling-target rows
    for the 'target' kind (target.py:44-47,68: theta advances 0.0025/step,
    orbit radius 10, constant target altitude 10)."""
    obs = x[jnp.array(spec.obs_indices)]
    if spec.negate_obs:
        obs = -obs
    if spec.kind == 'target':
        t = params.task
        theta = t.target_dtheta * (steps - 1).astype(x.dtype)
        tx = t.target_orbit_radius * jnp.cos(theta)
        ty = t.target_orbit_radius * jnp.sin(theta)
        talt = jnp.full_like(tx, t.target_altitude)
        obs = jnp.concatenate([obs, tx[None], ty[None], talt[None]], axis=0)
    return obs


def _initial_forces(base_key, env_ids, episode, params: EnvParams, dtype):
    """Per-env reset wind kick ~ U(-F, +F)^3 on (X, Y, Z) (task.py:177-188),
    keyed by (global env id, episode index) for layout independence."""
    f = params.task.initial_random_force

    def one(eid, ep):
        k = jax.random.fold_in(jax.random.fold_in(base_key, eid), ep)
        return jax.random.uniform(k, (3,), minval=-f, maxval=f, dtype=dtype)

    forces3 = jax.vmap(one)(env_ids, episode).T  # (3, B)
    return jnp.concatenate([forces3, jnp.zeros_like(forces3)], axis=0)  # (6, B)


def reset(
    base_key,
    env_ids,
    episode,
    params: EnvParams,
    spec: TaskSpec,
    *,
    pose=None,
    perturb_force=None,
    dtype=jnp.float32,
) -> Tuple[EnvState, jnp.ndarray]:
    """Build fresh state for a batch of envs == reference `_Task._reset`
    (task.py:145-197) *including* the trailing zero-action initializing step
    (task.py:197), which (a) leaves the dynamics untouched (setMotors is
    skipped when initializing), (b) seeds `prev_shaping` with the initial
    shaping value so the first real step's reward is a delta (lander.py:58-62),
    and (c) advances the step counter to 1.

    pose: optional (x, y, altitude, phi_deg, theta_deg) start pose
          (task.py:149-170; z is negated into NED, angles are degrees).
    perturb_force: optional (6, B) explicit force override for parity tests.
    Returns (EnvState, obs) with obs features-first (obs_dim, B).
    """
    env_ids = jnp.asarray(env_ids, jnp.int32)
    episode = jnp.asarray(episode, jnp.int32)
    b = env_ids.shape[0]

    if pose is None:
        altitude = (spec.start_altitude if spec.start_altitude is not None
                    else params.task.initial_altitude)
        pose = (spec.start_xy_offset, spec.start_xy_offset, altitude,
                0.0, 0.0)
    x = jnp.zeros((12, b), dtype)
    x = x.at[C.STATE_X].set(jnp.asarray(pose[0], dtype))
    x = x.at[C.STATE_Y].set(jnp.asarray(pose[1], dtype))
    x = x.at[C.STATE_Z].set(jnp.asarray(-pose[2], dtype))          # NED
    x = x.at[C.STATE_PHI].set(jnp.radians(jnp.asarray(pose[3], dtype)))
    x = x.at[C.STATE_THETA].set(jnp.radians(jnp.asarray(pose[4], dtype)))

    if perturb_force is not None:
        forces = jnp.asarray(perturb_force, dtype)
    elif spec.perturb_on_reset:
        forces = _initial_forces(base_key, env_ids, episode, params, dtype)
    else:
        forces = jnp.zeros((6, b), dtype)

    dyn = dynamics.init_state(x, dtype=dtype)
    dyn = dynamics.perturb(dyn, forces, params.vehicle)

    if spec.integrate_on_reset:
        # the attic simple task's reset runs a genuine zero-demand step
        # (simple_lander3d.py:79): one Euler integration of free fall
        # before the first observation; shaping is seeded from the
        # integrated state (prev_shaping set inside that step, :115-120)
        dyn = dynamics.step(dyn, jnp.zeros((4, b), dtype), params.vehicle,
                            params.world, params.task.dt,
                            lift_model=params.lift_model)
        x = dyn.x

    prev_shaping = _shaping(x, params, spec)
    steps = jnp.ones((b,), jnp.int32)
    state = EnvState(
        dyn=dyn,
        prev_shaping=prev_shaping,
        steps=steps,
        episode=episode,
        initial_random_x=jnp.sign(forces[1]),
    )
    return state, _get_obs(x, steps, params, spec)


def _raw_step(state: EnvState, action, params: EnvParams, spec: TaskSpec):
    """One environment transition without auto-reset == `_Task.step`
    (task.py:77-137), branchless."""
    x_dtype = state.dyn.x.dtype
    entry_status = state.dyn.status
    landed = entry_status == C.STATUS_LANDED

    action = jnp.asarray(action, x_dtype)
    if spec.action_mode == 'clip01':
        # clip to [0,1] despite the declared [-1,1] action space (task.py:91)
        motors = jnp.clip(action, 0.0, 1.0)
    elif spec.action_mode == 'rescale01':
        motors = (1.0 + action) / 2.0       # althold.py:38-42, target.py:38-40
    elif spec.action_mode == 'demand3':
        # throttle clipped to [0,1] pre-mix; roll/pitch demands stay
        # signed (simple_lander3d.py:84-87)
        motors = action.at[0].set(jnp.clip(action[0], 0.0, 1.0))
    else:
        motors = action                     # takeoff.py:67 raw pass-through
    spinning = (~landed) & (jnp.sum(motors, axis=0) > 0)
    mix = jnp.asarray(spec.mix_matrix, x_dtype)
    # HIGHEST: an f32 dot on the GPU may otherwise run in TF32
    motors4 = jnp.matmul(mix, motors,
                         precision=jax.lax.Precision.HIGHEST)  # (4, B)
    if spec.action_mode == 'demand3':
        # the MIXED motor values are clipped to [0,1] (simple_lander3d.py:99)
        motors4 = jnp.clip(motors4, 0.0, 1.0)

    stepped = dynamics.step(state.dyn, motors4, params.vehicle,
                            params.world, params.task.dt,
                            lift_model=params.lift_model)
    if spec.skip_when_landed:
        # motors (and the whole dynamics update) are skipped once safely
        # landed (task.py:86-94)
        dyn = _tree_where(landed, state.dyn, stepped)
    else:
        dyn = stepped
    x = dyn.x

    reward, shaping, done_r = _reward(entry_status, x, state.prev_shaping,
                                      params, spec)

    t = params.task
    if spec.termination == 'standard':
        oob = ((jnp.abs(x[C.STATE_X]) >= t.bounds)
               | (jnp.abs(x[C.STATE_Y]) >= t.bounds))
        tilt = ((jnp.abs(x[C.STATE_PHI]) >= t.max_angle)
                | (jnp.abs(x[C.STATE_THETA]) >= t.max_angle))
        crashed = entry_status == C.STATUS_CRASHED
        penalty = jnp.asarray(t.out_of_bounds_penalty, x_dtype)
        # out-of-bounds SUBTRACTS the penalty; tilt REPLACES the reward
        # (task.py:111-118)
        reward = jnp.where(oob, reward - penalty,
                           jnp.where(tilt, -penalty, reward))
        done = done_r | oob | tilt | crashed
    elif spec.termination == 'simple':
        # attic simple lander: out-of-bounds AND excess tilt both REPLACE
        # the reward with -OUT_OF_BOUNDS_PENALTY and terminate
        # (simple_lander3d.py:124-133 — EXCESS_ANGLE_PENALTY is defined at
        # :32 but never used); the inside-radius bonus is added AFTERWARDS
        # on the landed step (:135-141), and a crash terminates silently.
        oob = ((jnp.abs(x[C.STATE_X]) >= t.bounds)
               | (jnp.abs(x[C.STATE_Y]) >= t.bounds))
        tilt = ((jnp.abs(x[C.STATE_PHI]) >= t.max_angle)
                | (jnp.abs(x[C.STATE_THETA]) >= t.max_angle))
        crashed = entry_status == C.STATUS_CRASHED
        penalty = jnp.asarray(t.out_of_bounds_penalty, x_dtype)
        reward = jnp.where(oob | tilt, -penalty, reward)
        rp = params.reward
        landed = entry_status == C.STATUS_LANDED
        inside = (x[C.STATE_X] ** 2 + x[C.STATE_Y] ** 2
                  < rp.target_radius ** 2)
        reward = reward + jnp.where(
            landed & inside, jnp.asarray(rp.inside_radius_bonus, x_dtype),
            jnp.asarray(0.0, x_dtype))
        done = done_r | oob | tilt | crashed
    elif spec.termination == 'crash_only':
        done = dyn.status == C.STATUS_CRASHED   # target.py:41-42 (post-step)
    else:
        done = jnp.zeros(x.shape[1:], bool)

    done = done | (state.steps == t.max_steps)

    new_state = EnvState(
        dyn=dyn,
        prev_shaping=shaping,
        steps=state.steps + 1,
        episode=state.episode,
        initial_random_x=state.initial_random_x,
    )
    # target-kind obs uses the entry step count: the n-th step call sees
    # theta = dtheta*(n-1), matching target.py:44-47's post-increment
    obs = _get_obs(x, state.steps, params, spec)
    return new_state, obs, reward, done, spinning


def step(
    state: EnvState,
    action,
    base_key,
    env_ids,
    params: EnvParams,
    spec: TaskSpec,
) -> Tuple[EnvState, TimeStep]:
    """Environment step with folded-in auto-reset: finished slots are
    replaced in place by freshly reset episodes (the batched analogue of
    the reference's per-episode `Dynamics()` allocation, task.py:161)."""
    new_state, obs, reward, done, spinning = _raw_step(state, action, params, spec)

    fresh_state, fresh_obs = reset(
        base_key, env_ids, state.episode + 1, params, spec,
        dtype=state.dyn.x.dtype,
    )
    out_state = _tree_where(done, fresh_state, new_state)
    out_obs = jnp.where(done, fresh_obs, obs)

    ts = TimeStep(obs=out_obs, reward=reward, done=done,
                  status=new_state.dyn.status, spinning=spinning,
                  x=new_state.dyn.x)
    return out_state, ts
