#!/usr/bin/env python3
"""Adaptive disturbance-rejection demo — the batched counterpart of the
reference's Nengo PES hover experiment (attic/nengo/adaptive.py).

Runs a SWEEP of wind forces in one batched compiled rollout: every plant
has its own disturbance and its own online-adapting weights.  Prints the
final tracking error with and without adaptation, optionally saves a
comparison plot / CSV.

Usage:
  python scripts/adaptive_demo.py [--winds -4 -2 0 2 4] [--steps 6000]
      [--plot adaptive.png] [--save adaptive.csv]
"""

import argparse
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax.numpy as jnp

from gym_copter_tpu.core import vehicles
from gym_copter_tpu.core.types import EnvParams
from gym_copter_tpu.learn import adaptive


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--winds', type=float, nargs='+',
                   default=[-4.0, -2.0, 0.0, 2.0, 4.0],
                   help='sustained vertical wind forces (N), one plant each')
    p.add_argument('--steps', type=int, default=6000)
    p.add_argument('--plot', default=None, help='save a comparison figure')
    p.add_argument('--save', default=None, help='save altitude traces CSV')
    args = p.parse_args()

    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    winds = jnp.asarray(args.winds, jnp.float32)
    cfg = adaptive.AdaptiveConfig()

    results = {}
    for flag in (False, True):
        h = adaptive.run(params, winds, args.steps, cfg, adapt=flag)
        err = np.asarray(adaptive.tracking_error(h, cfg))
        results[flag] = (h, err)
        label = 'adaptive ' if flag else 'PD only  '
        print(f'{label} final |z - {cfg.target:.0f}m| per wind: '
              + np.array2string(err, precision=3))

    improvement = results[False][1] / np.maximum(results[True][1], 1e-9)
    print('improvement factor per wind:',
          np.array2string(improvement, precision=1))

    dt = params.task.dt
    t = dt * np.arange(args.steps)
    if args.save:
        z_off = np.asarray(results[False][0]['z'])
        z_on = np.asarray(results[True][0]['z'])
        with open(args.save, 'w') as f:
            cols = [f'z_pd_w{w:+.0f}' for w in args.winds] + \
                   [f'z_adapt_w{w:+.0f}' for w in args.winds]
            f.write('t,' + ','.join(cols) + '\n')
            for i in range(args.steps):
                row = [t[i]] + list(z_off[i]) + list(z_on[i])
                f.write(','.join(f'{v:.4f}' for v in row) + '\n')
        print('saved', args.save)

    if args.plot:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharey=True)
        for ax, flag, title in ((axes[0], False, 'PD only'),
                                (axes[1], True, 'PD + PES adaptation')):
            z = np.asarray(results[flag][0]['z'])
            for j, w in enumerate(args.winds):
                ax.plot(t, z[:, j], label=f'wind {w:+.0f} N', lw=0.9)
            ax.axhline(cfg.target, color='0.6', ls='--', lw=0.8)
            ax.set_title(title)
            ax.set_xlabel('time (s)')
        axes[0].set_ylabel('altitude (m)')
        axes[1].legend(fontsize=8)
        fig.savefig(args.plot, dpi=110, bbox_inches='tight')
        print('saved', args.plot)


if __name__ == '__main__':
    main()
