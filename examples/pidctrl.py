#!/usr/bin/env python3
"""Altitude-PID dynamics check with plots — the counterpart of the
reference's attic/examples/pidctrl.py ("Run simple altitude-hold PID
controller to test dynamics"): the cascaded altitude-hold PID drives
AltHold-v0 through the Gymnasium adapter, then reward / altitude /
velocity / action traces are plotted for eyeballing.

Usage: python examples/pidctrl.py [--duration 10] [--save pidctrl.png]
"""

import argparse
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax.numpy as jnp


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--duration', type=float, default=10.0)
    p.add_argument('--save', default=None,
                   help='save the figure instead of showing it')
    args = p.parse_args()

    from gym_copter_tpu.compat.gym_adapter import GymCopterEnv
    from gym_copter_tpu.control import pid
    from gym_copter_tpu.core import vehicles
    from gym_copter_tpu.core.types import EnvParams

    # the attic examples ran on the attic vehicle (B=5e-6), whose hover
    # point sits at motor ~0.52 — exactly where the PID's (1+demand)/2
    # rescale is centered; the active B=5e-3 vehicle hovers at 0.016
    env = GymCopterEnv('AltHold-v0',
                       params=EnvParams(vehicle=vehicles.DJI_PHANTOM_ATTIC))
    obs, _ = env.reset(seed=0)
    pstate = pid.setpoint_init(1)

    tvals, zvals, vvals, uvals, rvals = [], [], [], [], []
    u = -1.0                                  # motors initially off
    total_steps = int(args.duration * env.FRAMES_PER_SECOND)
    for step in range(total_steps):
        obs, reward, done, _, _ = env.step(np.array([u], np.float32))
        alt, climb = float(obs[0]), float(obs[1])   # AltHold obs is ENU
        # the cascaded altitude-hold PID works on NED state
        pstate, demand = pid.altitude_hold(
            pstate, jnp.asarray([-alt]), jnp.asarray([-climb]),
            target=env._env.params.task.althold_target)
        # the PID emits a [-1,1] "todo"; the AltHold env itself rescales
        # (1+a)/2 -> motors (althold.py:38-42)
        u = float(np.clip(float(demand[0]), -1.0, 1.0))
        tvals.append(step / env.FRAMES_PER_SECOND)
        zvals.append(alt)
        vvals.append(climb)
        uvals.append(u)
        rvals.append(float(reward))
        if done:
            break

    on_target = np.mean(np.abs(np.asarray(zvals[len(zvals) // 2:])
                               - env._env.params.task.althold_target) < 1.0)
    print(f'steps = {len(tvals)}   on-target fraction (2nd half) = '
          f'{on_target:.2f}')

    import matplotlib
    if args.save:
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    for k, (series, label) in enumerate((
            (rvals, 'Reward'), (zvals, 'Altitude (m)'),
            (vvals, 'Velocity (m/s)'), (uvals, 'Action'))):
        plt.subplot(4, 1, k + 1)
        plt.plot(tvals, series)
        plt.ylabel(label)
    plt.ylim([-1.1, 1.1])
    plt.xlabel('time (s)')
    if args.save:
        plt.savefig(args.save, dpi=110)
        print('saved', args.save)
    else:
        plt.show()
    env.close()


if __name__ == '__main__':
    main()
