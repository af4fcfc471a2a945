"""Environment registry and the user-facing batched environment handle.

The reference exposes envs through the Gymnasium registry
(gym_copter/__init__.py:9-13, `gym.make('gym_copter:Lander-v0')`); the
batched equivalent here is a factory returning a `CopterEnv`: a thin,
immutable handle bundling (jitted reset, jitted auto-resetting step, scan
rollout) for N lockstep environments on the current device.  For the
single-env drop-in Gymnasium API, see gym_copter_tpu.compat.gym_adapter.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from gym_copter_tpu.core.types import EnvParams, TaskParams
from gym_copter_tpu.core import vehicles
from gym_copter_tpu.envs import base, tasks
from gym_copter_tpu.envs.base import EnvState, TaskSpec, TimeStep


def default_params(dtype=jnp.float32) -> EnvParams:
    return EnvParams(vehicle=vehicles.DJI_PHANTOM)


class CopterEnv:
    """A batch of B identical copter environments stepping in lockstep.

    All methods are pure: state is threaded explicitly, so the same handle
    works under jit, scan, shard_map, and across devices.  `env_id_offset`
    gives each shard its global env-id range so randomness is identical
    regardless of sharding layout.
    """

    def __init__(self, spec: TaskSpec, params: Optional[EnvParams] = None,
                 num_envs: int = 1, seed: int = 0,
                 env_id_offset: int = 0, dtype=jnp.float32):
        self.spec = spec
        self.params = params if params is not None else default_params(dtype)
        self.num_envs = num_envs
        self.dtype = dtype
        self.base_key = jax.random.PRNGKey(seed)
        self.env_ids = env_id_offset + jnp.arange(num_envs, dtype=jnp.int32)

        self._reset = jax.jit(functools.partial(
            base.reset, params=self.params, spec=self.spec, dtype=self.dtype))
        self._step = jax.jit(functools.partial(
            base.step, params=self.params, spec=self.spec))
        self._rollout_cache = {}

    @property
    def observation_size(self) -> int:
        return self.spec.obs_size

    @property
    def action_size(self) -> int:
        return self.spec.action_size

    def reset(self, episode=0, pose=None, perturb_force=None):
        """Returns (EnvState, obs) with obs features-first (obs_dim, B)."""
        episode = jnp.full((self.num_envs,), episode, jnp.int32)
        if pose is not None or perturb_force is not None:
            # un-jitted path for custom poses / injected forces (tests, demos)
            return base.reset(self.base_key, self.env_ids, episode,
                              self.params, self.spec, pose=pose,
                              perturb_force=perturb_force, dtype=self.dtype)
        return self._reset(self.base_key, self.env_ids, episode)

    def step(self, state: EnvState, action) -> tuple[EnvState, TimeStep]:
        """Auto-resetting batched step; action is (action_size, B)."""
        return self._step(state, action, self.base_key, self.env_ids)

    def rollout(self, state: EnvState, policy_fn, num_steps: int,
                policy_state=None, obs=None):
        """Run `num_steps` env steps as one `lax.scan` inside one jit — the
        whole T-step trajectory is a single XLA program (SURVEY.md §7
        "Throughput").

        policy_fn(policy_state, obs) -> (policy_state, action) with obs
        features-first.  Returns (final_state, final_policy_state,
        trajectory TimeStep stacked on a leading T axis).

        The whole scan is jitted once per (policy_fn, num_steps) and cached
        on the handle, so repeated rollouts pay zero retrace cost.
        """
        cache_key = (policy_fn, num_steps)
        if cache_key not in self._rollout_cache:

            def run(state, policy_state, obs, base_key, env_ids):
                def scan_step(carry, _):
                    env_state, pol_state, obs = carry
                    pol_state, action = policy_fn(pol_state, obs)
                    env_state, ts = base.step(env_state, action, base_key,
                                              env_ids, self.params, self.spec)
                    return (env_state, pol_state, ts.obs), ts

                (state, policy_state, _), traj = jax.lax.scan(
                    scan_step, (state, policy_state, obs), None,
                    length=num_steps)
                return state, policy_state, traj

            self._rollout_cache[cache_key] = jax.jit(run)

        if obs is None:
            obs = base._get_obs(state.dyn.x, state.steps, self.params,
                                self.spec)
        return self._rollout_cache[cache_key](
            state, policy_state, obs, self.base_key, self.env_ids)

    def fused_rollout(self, state: EnvState, action, num_steps: int,
                      seed: int = 0):
        """Run `num_steps` auto-resetting steps with a constant action.  On
        the GPU this is ONE Pallas kernel launch (ops/pallas_rollout.py);
        elsewhere, and for task kinds outside the kernel's family, it is the
        XLA scan.  Returns (EnvState, totals) with totals = {'reward_sum':
        (B,), 'episodes': (B,), 'path': 'fused'|'scan'} so callers can
        assert which path executed."""
        from gym_copter_tpu.ops import pallas_rollout as pr

        path = rollout_path(jax.default_backend(), self.params, self.spec)
        if path == 'fused':
            state, totals = pr.fused_rollout(state, action, num_steps,
                                             self.params, self.spec,
                                             seed=seed, env_ids=self.env_ids)
        else:
            state, totals = pr.scan_rollout(state, action, self.base_key,
                                            self.env_ids, num_steps,
                                            self.params, self.spec)
        totals['path'] = path
        return state, totals

    def run_episode(self, state: EnvState, actions):
        """Step through a pre-scripted action sequence (T, A, B) as one
        scan; returns (final_state, trajectory TimeStep with leading T
        axis).  The open-loop analogue of the reference demo loop
        (lander.py:40-65)."""
        if 'episode' not in self._rollout_cache:

            def run(state, actions, base_key, env_ids):
                def scan_step(env_state, action):
                    env_state, ts = base.step(env_state, action, base_key,
                                              env_ids, self.params, self.spec)
                    return env_state, ts

                return jax.lax.scan(scan_step, state, actions)

            self._rollout_cache['episode'] = jax.jit(run)
        return self._rollout_cache['episode'](state, actions, self.base_key,
                                              self.env_ids)


def rollout_path(platform: str, params: EnvParams, spec: TaskSpec) -> str:
    """Which implementation `CopterEnv.fused_rollout` runs on `platform`:
    the compiled kernel ('fused') on the GPU for task kinds in its family,
    the XLA scan ('scan') everywhere else."""
    from gym_copter_tpu.ops import pallas_rollout as pr

    if platform == 'gpu' and pr.supports(params, spec):
        return 'fused'
    return 'scan'


def make(name: str, num_envs: int = 1, params: Optional[EnvParams] = None,
         seed: int = 0, env_id_offset: int = 0, dtype=jnp.float32) -> CopterEnv:
    """Factory: `make('Lander3D-v0', num_envs=4096)`.

    Mirrors the reference registry ids (gym_copter/__init__.py:9-13 and
    attic/gym_copter/__init__.py:9-38) plus the Hover family.
    """
    if name not in tasks.ALL_TASKS:
        raise KeyError(
            f'Unknown env {name!r}; available: {sorted(tasks.ALL_TASKS)}')
    if params is None and name in tasks.PRESET_PARAMS:
        params = tasks.PRESET_PARAMS[name]()
    return CopterEnv(tasks.ALL_TASKS[name], params=params, num_envs=num_envs,
                     seed=seed, env_id_offset=env_id_offset, dtype=dtype)


def list_envs():
    return sorted(tasks.ALL_TASKS)
