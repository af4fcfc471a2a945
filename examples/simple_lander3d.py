#!/usr/bin/env python3
"""Simple-lander PD-expert runner — the counterpart of the reference's
attic/gym_copter/envs/simple_lander3d.py:214-244 embedded
`heuristic_lander` loop: the PD expert flies the 3-demand (throttle, roll,
pitch) lander from its fixed +2.5 m X/Y offset down to a centered landing,
printing observations and total reward every 20 steps and on termination.

Usage: python examples/simple_lander3d.py [--steps 600] [--movie out.mp4]
"""

import argparse
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--steps', type=int, default=600)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--movie', default=None,
                   help='save the replayed 3D view to this mp4/gif')
    args = p.parse_args()

    from gym_copter_tpu.compat.gym_adapter import GymCopterEnv
    from gym_copter_tpu.control.heuristics import lander3d_simple_pid

    env = GymCopterEnv('Lander3DSimple-v0')
    obs, _ = env.reset(seed=args.seed)
    _, policy = lander3d_simple_pid(1)

    poses = []
    total = 0.0
    for step in range(args.steps):
        _, action = policy(None, np.asarray(obs, np.float64)[:, None])
        obs, reward, done, _, _ = env.step(np.asarray(action[:, 0]))
        total += reward
        poses.append(env.pose)
        if step % 20 == 0 or done:
            print('observations:',
                  ' '.join('%+0.2f' % v for v in np.asarray(obs)))
            print('step {} total_reward {:+0.2f}'.format(step, total))
        if done:
            break
    x, y = env.pose[0], env.pose[1]
    print('landed at (%.2f, %.2f), total reward %+0.2f%s'
          % (x, y, total, '  [inside-radius bonus]' if total > 100 else ''))

    if args.movie:
        import matplotlib
        matplotlib.use('Agg')
        from gym_copter_tpu.render.threed import ThreeDLanderRenderer
        r = ThreeDLanderRenderer()
        r.play(np.asarray(poses), fps=env.FRAMES_PER_SECOND,
               outfile=args.movie, show=False)
        print('wrote', args.movie)
    env.close()


if __name__ == '__main__':
    main()
