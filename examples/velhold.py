#!/usr/bin/env python3
"""Constant-climb-rate PID dynamics check — the counterpart of the
reference's attic/velhold.py ("Run simple constant-climb-rate PID
controller to test dynamics"): a velocity PI controller (P=0.1, I=0.1,
windup 10, attic/velhold.py:19-22,24-56) holds dZ/dt at +1 m/s against the
raw dynamics core, then altitude / velocity / motor traces are plotted in
the reference's 3-panel layout (attic/velhold.py:100-110).

Batched shape: the reference steps a scalar env in a 10,000-iteration
Python loop at dt=0.001 (attic/velhold.py:15,78-97); here the whole run is
ONE `lax.scan` over `core.dynamics.step` carrying (DynamicsState, PI
state, motor value), jit-compiled once, returning the full trace arrays.

Usage: python examples/velhold.py [--duration 10] [--save velhold.png]
"""

import argparse
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DT = 0.001        # attic CopterEnv dt (attic/gym_copter/envs/copter.py:40)
TARGET = 1.0      # m/s climb rate (attic/velhold.py:17)
KP, KI = 0.1, 0.1  # attic/velhold.py:20-21
WINDUP = 10.0     # attic/velhold.py:24 windupMax


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--duration', type=float, default=10.0)
    p.add_argument('--save', default=None,
                   help='save the figure instead of showing it')
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from gym_copter_tpu.core import dynamics, vehicles
    from gym_copter_tpu.core.types import WorldParams

    # the attic scripts fly the attic vehicle (B=5e-6 — SURVEY.md §2.4
    # parameter discrepancy); its hover motor value is ~0.52, so a
    # [0,1]-clipped PI can actually climb
    vp = vehicles.DJI_PHANTOM_ATTIC
    world = WorldParams()
    n = int(args.duration / DT)

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    @jax.jit
    def run():
        state = dynamics.init_state(jnp.zeros((12, 1), dtype), dtype=dtype)

        def step_fn(carry, _):
            state, error_i, u = carry
            state = dynamics.step(state, jnp.full((4, 1), u), vp, world, DT)
            alt = -state.x[4, 0]    # NED -> altitude (attic/velhold.py:85)
            vel = -state.x[5, 0]
            # velocity PI with integral windup clamp (attic/velhold.py:44-53)
            error = TARGET - vel
            error_i = jnp.clip(error_i + error * DT, -WINDUP, WINDUP)
            u = jnp.clip(KP * error + KI * error_i, 0.0, 1.0)
            return (state, error_i, u), (alt, vel, u)

        (_, _, _), (alts, vels, us) = jax.lax.scan(
            step_fn, (state, dtype(0.0), dtype(0.0)), None, length=n)
        return alts, vels, us

    alts, vels, us = map(np.asarray, run())
    tvals = np.linspace(0, args.duration, n)

    # dynamics check: the climb rate should settle at the setpoint
    settled = vels[n // 2:]
    print(f'steps = {n}   mean climb rate (2nd half) = {settled.mean():.3f} '
          f'm/s (target {TARGET})   final altitude = {alts[-1]:.2f} m')

    import matplotlib
    if args.save:
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    for k, (series, label) in enumerate(((alts, 'Altitude (m)'),
                                         (vels, 'Velocity (m/s)'),
                                         (us, 'Motors'))):
        plt.subplot(3, 1, k + 1)
        plt.plot(tvals, series)
        plt.ylabel(label)
    plt.xlabel('Time (s)')
    if args.save:
        plt.savefig(args.save, dpi=110)
        print('saved', args.save)
    else:
        plt.show()


if __name__ == '__main__':
    main()
