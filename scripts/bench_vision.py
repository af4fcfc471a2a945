#!/usr/bin/env python3
"""Batched-vision benchmark on one GPU.

sensors/vision.py claims the analytic inverse-warp camera "vmaps over
thousands of environments"; this records the evidence: env-steps/s for a
full VisualCopterEnv rollout (physics step + per-step image batch, images
consumed on-device by a jitted reduction so the camera work cannot be
dead-code-eliminated) at 1024 and 4096 envs, res 16 (the reference wrapper
resolution, attic/gym_copter/envs/lander.py:103) and res 64, plus the DVS
event-camera variant at res 16.

Each configuration times STEPS-step rollouts (median and MAD spread of
`--reps` calls, each waited for with `block_until_ready`).  Refuses to run
without a GPU.

Usage:  python scripts/bench_vision.py [--out vision.json]
"""

import argparse
import json
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import gym_copter_tpu as gct
from gym_copter_tpu.envs.visual import VisualCopterEnv, VisualState
from gym_copter_tpu.sensors.vision import DVS, VisionSensor
from gym_copter_tpu.utils import compile_cache, profiling

STEPS = 200


def bench_config(num_envs: int, res: int, dvs: bool, reps: int = 6):
    env = gct.make('Lander3D-v0', num_envs=num_envs, seed=0)
    sensor = DVS(res=res) if dvs else VisionSensor(res=res)
    venv = VisualCopterEnv(env, dvs=dvs, sensor=sensor)
    action = jnp.full((4, num_envs), 1.625e-2, jnp.float32)

    import functools

    @functools.partial(jax.jit, static_argnums=1)
    def rollout(state: VisualState, num_steps):
        def step_fn(carry, _):
            state, acc = carry
            state, ts, img = venv.step(state, action)
            # consume the image on-device: pixel sum keeps the camera live
            return (state, acc + img.sum() + ts.reward.sum()), None

        (state, acc), _ = jax.lax.scan(step_fn, (state, 0.0), None,
                                       length=num_steps)
        return state, acc

    state0, _ = venv.reset()

    res_ = profiling.steps_per_sec(lambda: rollout(state0, STEPS)[1],
                                   num_envs * STEPS, reps=reps)
    return {
        'env_steps_per_sec': res_['steps_per_sec'],
        'images_per_sec': res_['steps_per_sec'],  # one image per env-step
        'spread_pct': res_['spread_pct'],
        'us_per_batched_step': res_['seconds'] / STEPS * 1e6,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--out', default=None)
    p.add_argument('--reps', type=int, default=6)
    args = p.parse_args()
    if jax.default_backend() != 'gpu':
        sys.exit(f'bench_vision: no GPU found (JAX backend '
                 f'{jax.default_backend()!r})')
    compile_cache.enable()

    dev = jax.devices()[0]
    results = {'device': {'platform': dev.platform,
                          'kind': dev.device_kind},
               'env': 'Lander3D-v0', 'steps_per_rollout': STEPS,
               'configs': []}
    for num_envs, res, dvs in ((1024, 16, False), (4096, 16, False),
                               (1024, 64, False), (1024, 16, True)):
        label = f'{num_envs}envs_res{res}' + ('_dvs' if dvs else '')
        print(f'benchmarking {label} ...', flush=True)
        r = bench_config(num_envs, res, dvs, reps=args.reps)
        r.update({'num_envs': num_envs, 'res': res, 'dvs': dvs,
                  'label': label})
        results['configs'].append(r)
        print(json.dumps(r, indent=1), flush=True)

    if args.out:
        with open(args.out, 'w') as f:
            json.dump(results, f, indent=1)
        print('wrote', args.out)


if __name__ == '__main__':
    main()
