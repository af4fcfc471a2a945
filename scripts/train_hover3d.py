#!/usr/bin/env python3
"""Hover3D PPO learning-curve validation (BASELINE.json configs[3]).

Trains the actor-learner on one host, starting from a motors-off policy,
and records the deterministic-eval learning curve.  A representative run
reaches eval_return ~833/999 after 1500 updates (~196M env steps) from the
free-fall baseline ~146.

Usage:
  python scripts/train_hover3d.py [--updates N] [--envs B] [--seed S]
      [--out curve.json] [--ckpt DIR]
"""

import argparse
import json
import os
import sys

# allow `python scripts/train_hover3d.py` from anywhere: the package lives
# next to this script's parent directory (appended, not prepended, so the
# repo's top-level `utils/` can't shadow third-party imports)
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from gym_copter_tpu.learn import ppo
from gym_copter_tpu.utils import checkpoint


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--updates', type=int, default=1500)
    p.add_argument('--envs', type=int, default=1024)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--rollout', type=int, default=128)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--out', default='hover3d_curve.json')
    p.add_argument('--ckpt', default=None,
                   help='directory (orbax) or .npz file for the final state')
    p.add_argument('--log-every', type=int, default=50)
    args = p.parse_args()

    cfg = ppo.PPOConfig(rollout_steps=args.rollout, entropy_coef=0.0,
                        learning_rate=args.lr)
    ts, history = ppo.train('Hover3D-v0', num_envs=args.envs,
                            num_updates=args.updates, seed=args.seed,
                            cfg=cfg, log_every=args.log_every)

    curve = [{'update': i, **m} for i, m in history]
    steps_per_update = args.envs * args.rollout
    summary = {
        'env': 'Hover3D-v0',
        'seed': args.seed,
        'env_steps': args.updates * steps_per_update,
        'first_eval_return': curve[0]['eval_return'],
        'best_eval_return': max(c['eval_return'] for c in curve),
        'final_eval_return': curve[-1]['eval_return'],
        'curve': curve,
    }
    with open(args.out, 'w') as f:
        json.dump(summary, f, indent=1)
    print('wrote', args.out)
    print('eval_return: first %.1f  best %.1f  final %.1f' % (
        summary['first_eval_return'], summary['best_eval_return'],
        summary['final_eval_return']))

    if args.ckpt:
        checkpoint.save(args.ckpt, ts)
        print('checkpoint saved to', args.ckpt)


if __name__ == '__main__':
    main()
