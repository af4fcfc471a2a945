#!/usr/bin/env python3
"""Climb-and-leap open-loop demo — the counterpart of the reference's
attic/examples/leap.py: full throttle until the target altitude, then an
asymmetric motor pattern pitches the copter into forward flight until it
crashes or leaves the arena.

Usage: python examples/leap.py [--altitude 10]
"""

import argparse
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--altitude', type=float, default=10.0)
    p.add_argument('--steps', type=int, default=1200)
    args = p.parse_args()

    from gym_copter_tpu.compat.gym_adapter import GymCopterEnv
    from gym_copter_tpu.control.heuristics import hover_motor_value

    env = GymCopterEnv('Distance-v0')     # no bounds termination: free leap
    hover = hover_motor_value(env._env.params)
    obs, _ = env.reset(seed=0)

    climb = np.full(4, 2.0 * hover, np.float32)          # full climb
    leap = np.asarray([0, 2.0, 0, 2.0], np.float32) * hover  # pitch forward
    u = climb
    leaping = False
    dist = peak = 0.0
    for step in range(args.steps):
        obs, reward, done, _, _ = env.step(u)
        if done:
            break        # post-done obs belongs to the auto-reset episode
        z = -obs[4]
        dist = max(dist, float(np.hypot(obs[0], obs[2])))
        peak = max(peak, z)
        if not leaping and z > args.altitude:
            u = leap
            leaping = True
            print(f'leap! step {step}, altitude {z:.2f} m')
    print(f'steps = {step + 1}   distance = {dist:.2f} m   '
          f'peak altitude = {peak:.2f} m')
    env.close()


if __name__ == '__main__':
    main()
