"""gym_copter_tpu — a batched multicopter environment engine in JAX.

A from-scratch JAX/XLA reimplementation of the capability surface of
simondlevy/gym-copter (Bouabdallah-2004 quadrotor dynamics; Lander/Hover
1D/2D/3D tasks; PID heuristics; rendering; vision/DVS sensors), redesigned
for batched, sharded execution: thousands of environments step in lockstep
inside one jitted `lax.scan`, with reward shaping, termination, and
auto-reset folded into the branchless step.

Quick start:

    import gym_copter_tpu as gct
    env = gct.make('Lander3D-v0', num_envs=4096)
    state, obs = env.reset()
    state, ts = env.step(state, actions)   # actions: (4, 4096) in [0, 1]

Single-env Gymnasium drop-in:

    from gym_copter_tpu.compat.gym_adapter import GymCopterEnv
    env = GymCopterEnv('Lander-v0')
    obs, info = env.reset(seed=0)
    obs, reward, terminated, truncated, info = env.step(action)
"""

from gym_copter_tpu.core.types import (EnvParams, LanderRewardParams,
                                       TaskParams, VehicleParams, WorldParams)
from gym_copter_tpu.core import constants, vehicles
from gym_copter_tpu.envs.base import EnvState, TaskSpec, TimeStep
from gym_copter_tpu.envs.registry import CopterEnv, default_params, list_envs, make

__version__ = '0.1.0'

__all__ = [
    'CopterEnv', 'EnvParams', 'EnvState', 'LanderRewardParams', 'TaskParams',
    'TaskSpec', 'TimeStep', 'VehicleParams', 'WorldParams', 'constants',
    'default_params', 'list_envs', 'make', 'vehicles',
]
