#!/usr/bin/env python3
"""Target-chase demo: a real Target-v0 rollout feeding the dual-vehicle 3D
view (the reference's ThreeDTarget renderer, attic threed_target.py:11-24,
fed from the env's circling-target track, attic target.py:44-47).

The chaser flies the altitude-hold PID at the target's altitude while the
target circles at radius 10; both tracks come from ONE compiled rollout of
the actual env (the target coordinates are rows 12-14 of the observation).

Usage:
  python target_demo.py                       # animate chaser + target
  python target_demo.py --movie --nodisplay   # headless movie
"""

import argparse
from argparse import ArgumentDefaultsHelpFormatter

import numpy as np

import jax.numpy as jnp

import gym_copter_tpu as gct
from gym_copter_tpu.control import heuristics


def main():
    parser = argparse.ArgumentParser(
        formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument('--movie', action='store_true')
    parser.add_argument('--view', default='30,120')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--steps', type=int, default=800)
    parser.add_argument('--nodisplay', action='store_true')
    args = parser.parse_args()

    env = gct.make('Target-v0', num_envs=1, seed=args.seed)
    dt = env.params.task.dt
    state, obs = env.reset()

    # Target actions are rescaled (1+a)/2 (attic target.py:38-40); wrap the
    # hover PID so its [0,1] motor commands map through that rescale, with
    # the altitude target set to the orbit altitude.
    pid_state, pid_fn = heuristics.hover3d_pid(
        batch=1, params=env.params,
        target=float(env.params.task.target_altitude))

    def policy_fn(pstate, obs):
        pstate, motors = pid_fn(pstate, obs[:12])
        return pstate, 2.0 * motors - 1.0       # invert the env's rescale

    state, _, traj = env.rollout(state, policy_fn, args.steps,
                                 policy_state=pid_state, obs=obs)

    done = np.asarray(traj.done[:, 0])
    end = int(done.argmax()) + 1 if done.any() else args.steps
    pose_log = np.asarray(traj.x[:end, (0, 2, 4, 6, 8, 10), 0])
    target_xy = np.asarray(traj.obs[:end, 12:14, 0])
    target_alt = np.asarray(traj.obs[:end, 14, 0])
    target_xyz = np.column_stack([target_xy, -target_alt])  # NED z
    print(f'steps = {end}   chaser altitude '
          f'{-pose_log[-1, 2]:.2f} m   target at '
          f'({target_xyz[-1, 0]:+.2f}, {target_xyz[-1, 1]:+.2f})')

    if not args.nodisplay or args.movie:
        from gym_copter_tpu.render.threed import ThreeDTargetRenderer
        renderer = ThreeDTargetRenderer(
            viewangles=tuple(int(s) for s in args.view.split(',')))
        renderer.play_pair(pose_log, target_xyz, fps=int(round(1 / dt)),
                           outfile='target.mp4' if args.movie else None,
                           show=not args.nodisplay)


if __name__ == '__main__':
    main()
