#!/usr/bin/env python3
"""PID hover demo — the analogue of the reference's attic hover demos
(attic/heuristic/hover.py, attic/mars/hover3d.py): the batched
altitude+position PID expert policy holds the copter at the start altitude.

The whole episode runs as ONE compiled rollout (policy included — the PID
stack is a functional jnp policy, control/heuristics.py), then the recorded
trajectory is replayed by the renderer / written to CSV.

Usage:
  python hover_demo.py                        # animate
  python hover_demo.py --save traj.csv        # CSV (copter-plot format)
  python hover_demo.py --movie --nodisplay    # headless movie
  python hover_demo.py --steps 500 --seed 3
"""

import argparse
from argparse import ArgumentDefaultsHelpFormatter

import numpy as np

import jax.numpy as jnp

import gym_copter_tpu as gct
from gym_copter_tpu.control import heuristics
from gym_copter_tpu.render.csvlog import write_csv


def main():
    parser = argparse.ArgumentParser(
        formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument('--save', dest='csvfilename',
                        help='Save trajectory in CSV file')
    parser.add_argument('--movie', action='store_true')
    parser.add_argument('--view', default='30,120')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--steps', type=int, default=999)
    parser.add_argument('--nodisplay', action='store_true')
    args = parser.parse_args()

    env = gct.make('Hover3D-v0', num_envs=1, seed=args.seed)
    dt = env.params.task.dt
    state, obs = env.reset()

    policy_state, policy_fn = heuristics.hover3d_pid(batch=1,
                                                     params=env.params)
    state, _, traj = env.rollout(state, policy_fn, args.steps,
                                 policy_state=policy_state, obs=obs)

    done = np.asarray(traj.done[:, 0])
    end = int(done.argmax()) + 1 if done.any() else args.steps
    total = float(np.asarray(traj.reward[:end, 0]).sum())
    pose_log = np.asarray(traj.x[:end, (0, 2, 4, 6, 8, 10), 0])
    alt = -pose_log[:, 2]
    print(f'steps = {end}   total_reward = {total:+.2f}   '
          f'altitude range [{alt.min():.2f}, {alt.max():.2f}] m')

    if args.csvfilename:
        obs_log = np.asarray(traj.obs[:end, :, 0])
        write_csv(args.csvfilename, dt * np.arange(end),
                  np.zeros((end, 4)), obs_log,
                  ['X', 'dX', 'Y', 'dY', 'Z', 'dZ',
                   'Phi', 'dPhi', 'Theta', 'dTheta', 'Psi', 'dPsi'])
        print('saved', args.csvfilename)

    if not args.nodisplay or args.movie:
        from gym_copter_tpu.render.threed import ThreeDHoverRenderer
        renderer = ThreeDHoverRenderer(
            viewangles=tuple(int(s) for s in args.view.split(',')))
        renderer.play(pose_log, fps=int(round(1 / dt)),
                      outfile='hover.mp4' if args.movie else None,
                      show=not args.nodisplay)


if __name__ == '__main__':
    main()
