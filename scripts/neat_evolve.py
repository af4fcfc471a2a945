#!/usr/bin/env python3
"""Evolve a NEAT-style controller — the NEAT-Gym `neat-evolve.py config/
lander2d` equivalent (attic/neat/README.md:17-23), batched.

Defaults mirror attic/neat/config/lander2d: pop_size 96, episode_reps 10,
fitness_threshold 300, env Lander2D-v0.  The whole population x reps batch
evaluates as one jitted scan per generation (learn/neuroevolution.py).

    python scripts/neat_evolve.py --env Lander2D-v0 --out docs/neat_lander2d.json

Writes a JSON learning record (per-generation best/mean fitness, robust
champion evaluation over fresh episodes) plus the champion genome as .npz —
the analogue of NEAT-Gym's models/<env>/<fitness>.dat.
"""

import argparse
import json
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from gym_copter_tpu.learn import neuroevolution as ne


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--env', default='Lander2D-v0')
    p.add_argument('--pop', type=int, default=96)
    p.add_argument('--reps', type=int, default=10)
    p.add_argument('--target', type=float, default=300.0)
    p.add_argument('--hidden', type=int, default=16)
    p.add_argument('--generations', type=int, default=1000)
    p.add_argument('--seeds', type=int, nargs='+', default=[0])
    p.add_argument('--eval-reps', type=int, default=100)
    p.add_argument('--anchor', default='hover', choices=['hover', 'direct'])
    p.add_argument('--algo', default='ga', choices=['ga', 'hyperneat'],
                   help="'ga' = direct-encoding masked-topology GA "
                        "(learn/neuroevolution.py); 'hyperneat' = "
                        "CPPN-generated substrate networks "
                        "(learn/hyperneat.py — the reference configs' "
                        "indirect-encoding family)")
    p.add_argument('--out', default=None, help='JSON record path')
    p.add_argument('--save-genome', default=None,
                   help='champion .npz path (best seed)')
    args = p.parse_args()

    if args.algo == 'hyperneat':
        from gym_copter_tpu.learn import hyperneat as hn
        cfg = hn.HyperNeatConfig(pop_size=args.pop, episode_reps=args.reps,
                                 fitness_threshold=args.target,
                                 action_anchor=args.anchor)
        evolve_population, evaluate_champion = (hn.evolve_population,
                                                hn.evaluate_champion)
    else:
        cfg = ne.NeatConfig(pop_size=args.pop, episode_reps=args.reps,
                            fitness_threshold=args.target,
                            hidden=args.hidden, action_anchor=args.anchor)
        evolve_population, evaluate_champion = (ne.evolve_population,
                                                ne.evaluate_champion)
    runs, best_champ, best_champ_score = [], None, -float('inf')
    for seed in args.seeds:
        t0 = time.time()
        champ, hist, _ = evolve_population(
            args.env, cfg, max_generations=args.generations, seed=seed)
        wall = time.time() - t0

        robust, _ = evaluate_champion(champ, args.env, cfg,
                                         reps=args.eval_reps)
        best = max(h['best_fitness'] for h in hist)
        train_gen = next((h['generation'] for h in hist
                          if h.get('train_threshold_reached')), None)
        print(f'{args.env} seed {seed}: best fitness {best:.1f} in '
              f'{len(hist)} generations ({wall:.0f}s, train threshold at '
              f'gen {train_gen}); champion over '
              f'{args.eval_reps} fresh episodes: {robust:.1f} '
              f'(target {args.target})', flush=True)
        runs.append({
            'seed': seed,
            'generations_run': len(hist),
            'best_fitness': best,
            'reached_target': bool(best >= args.target),
            'train_threshold_generation': train_gen,
            'champion_eval_mean': robust,
            'champion_eval_reached_target': bool(robust >= args.target),
            'best_holdout': max(h['holdout_best'] for h in hist),
            'wall_seconds': wall,
            'generations_per_sec': len(hist) / wall,
            'curve': hist,
        })
        if robust > best_champ_score:
            best_champ_score, best_champ = robust, champ

    record = {
        'env': args.env,
        'algorithm': ('hyperneat (CPPN-generated substrate)'
                      if args.algo == 'hyperneat'
                      else 'neat-style GA (masked topology)'),
        'config': {'algo': args.algo, 'pop_size': args.pop,
                   'episode_reps': args.reps,
                   'fitness_threshold': args.target, 'hidden': args.hidden,
                   'seeds': args.seeds, 'action_anchor': args.anchor},
        'champion_eval_reps': args.eval_reps,
        'env_steps_per_generation': args.pop * args.reps * cfg.max_steps,
        'seeds_reaching_target': sum(r['reached_target'] for r in runs),
        'champion_eval_seeds_reaching_target':
            sum(r['champion_eval_reached_target'] for r in runs),
        'best_fitness_across_seeds': max(r['best_fitness'] for r in runs),
        'runs': runs,
    }
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(record, f)
        print(f'wrote {args.out}')
    if args.save_genome and best_champ is not None:
        np.savez(args.save_genome,
                 **{k: np.asarray(v) for k, v in best_champ._asdict().items()})
        print(f'wrote {args.save_genome}')


if __name__ == '__main__':
    main()
