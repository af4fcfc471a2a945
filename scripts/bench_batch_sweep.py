#!/usr/bin/env python3
"""Fused-rollout throughput vs env-batch size on one GPU.

bench.py pins B=4096; this sweep records how per-card throughput scales
with the batch — the capacity-planning curve for choosing envs per card.
Each point times 1,000-step Lander3D rollouts through the fused kernel
(median and MAD spread of REPS calls, each waited for with
`block_until_ready`).  Refuses to run without a GPU.

Usage:  python scripts/bench_batch_sweep.py [--batches 4096 65536 ...]
                                            [--out sweep.json]
"""

import argparse
import json
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from gym_copter_tpu.core import vehicles
from gym_copter_tpu.core.types import EnvParams
from gym_copter_tpu.envs import base, tasks
from gym_copter_tpu.ops import pallas_rollout as pr
from gym_copter_tpu.utils import compile_cache, profiling

T = 1000
REPS = 8


def bench_batch(b: int):
    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    spec = tasks.LANDER_3D
    env_ids = jnp.arange(b, dtype=jnp.int32)
    state, _ = base.reset(jax.random.PRNGKey(0), env_ids,
                          jnp.zeros(b, jnp.int32), params, spec)
    action = jnp.full((4, b), 1.625e-2, jnp.float32)
    res = profiling.steps_per_sec(
        lambda: pr.fused_rollout(state, action, T, params, spec)[1],
        b * T, reps=REPS)
    return {
        'num_envs': b,
        'env_steps_per_sec': res['steps_per_sec'],
        'spread_pct': res['spread_pct'],
        'seconds_per_rollout': res['seconds'],
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--out', default=None)
    p.add_argument('--batches', type=int, nargs='+',
                   default=[4096, 16384, 65536, 262144, 1048576])
    args = p.parse_args()
    if jax.default_backend() != 'gpu':
        sys.exit(f'bench_batch_sweep: no GPU found (JAX backend '
                 f'{jax.default_backend()!r})')
    compile_cache.enable()

    rows = []
    for b in args.batches:
        r = bench_batch(b)
        rows.append(r)
        print(json.dumps(r), flush=True)
    dev = jax.devices()[0]
    out = {'device': {'platform': dev.platform, 'kind': dev.device_kind},
           'env': 'Lander3D-v0', 'steps_per_rollout': T,
           'metric': 'fused_rollout env-steps/s vs batch, one card',
           'rows': rows}
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
        print('wrote', args.out)


if __name__ == '__main__':
    main()
