#!/usr/bin/env python3
"""Takeoff heuristic runner — the counterpart of the reference's
attic/gym_copter/envs/takeoff.py:113-173 embedded heuristic: a
velocity-PID climbs the copter from the ground to the 5 m target, printing
observations and reward every 20 steps.

Usage: python examples/takeoff.py [--steps 500]
"""

import argparse
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--steps', type=int, default=500)
    args = p.parse_args()

    from gym_copter_tpu.compat.gym_adapter import GymCopterEnv
    from gym_copter_tpu.control.heuristics import hover_motor_value

    env = GymCopterEnv('Takeoff-v0')
    target = env._env.params.task.takeoff_target
    hover = hover_motor_value(env._env.params)
    dt = 1.0 / env.FRAMES_PER_SECOND
    obs, _ = env.reset(seed=0)

    # the reference's heuristic: velocity setpoint proportional to the
    # altitude error, velocity P(+D) loop on top (takeoff.py:113-140)
    ALT_P, VEL_P = 1.0, 1.0
    last_error = 0.0
    total = 0.0
    for step in range(args.steps):
        z, dz = -obs[4], -obs[5]                  # NED -> ENU
        vel_target = (target - z) * ALT_P
        vel_error = vel_target - dz
        last_error = vel_error
        u = hover * (1.0 + VEL_P * vel_error)     # scaled around hover
        obs, reward, done, _, _ = env.step(np.full(4, u, np.float32))
        total += reward
        if step % 20 == 0 or done:
            print('steps =  %04d    altitude = %5.2f    '
                  'total_reward = %+0.3f' % (step, -obs[4], total))
        if done:
            break
    final_alt = float(-obs[4])
    print(f'final altitude {final_alt:.2f} m (target {target:.0f})')
    env.close()


if __name__ == '__main__':
    main()
