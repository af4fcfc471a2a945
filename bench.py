#!/usr/bin/env python3
"""Env-steps/s of the fused rollout kernel at 4,096 Lander3D envs on one GPU.

Times `ops/pallas_rollout.fused_rollout` (the whole T-step auto-resetting
rollout as one kernel) with the demo's constant thrust, each call waited for
with `block_until_ready`, after a warm-up call that compiles it.  Before
timing, the kernel's per-env episode counts are checked against the XLA
scan.  Refuses to run without a GPU.

Prints the device and the card's power limit on stderr, then exactly one
JSON line on stdout:
  {"metric": ..., "value": N, "unit": "env-steps/s", "spread_pct": N,
   "device": {"platform": ..., "kind": ..., "count": N}, "power_limit": ...}

Usage:  python bench.py
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from gym_copter_tpu.core import vehicles
from gym_copter_tpu.core.types import EnvParams
from gym_copter_tpu.envs import base, tasks
from gym_copter_tpu.ops import pallas_rollout as pr
from gym_copter_tpu.utils import compile_cache, profiling

B = 4096
T = 1000
REPS = 10


def main():
    if jax.default_backend() != 'gpu':
        sys.exit(f'bench.py: no GPU found (JAX backend '
                 f'{jax.default_backend()!r})')
    compile_cache.enable()
    dev = jax.devices()[0]
    device = {'platform': dev.platform, 'kind': dev.device_kind,
              'count': len(jax.devices())}
    power = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f'device {device}; {power}', file=sys.stderr)

    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    spec = tasks.LANDER_3D
    key = jax.random.PRNGKey(0)
    env_ids = jnp.arange(B, dtype=jnp.int32)
    state, _ = base.reset(key, env_ids, jnp.zeros(B, jnp.int32), params, spec)
    action = jnp.full((4, B), 1.625e-2, jnp.float32)  # demo heuristic thrust

    # correctness: fused episode counts == XLA-path episode counts
    _, ft = pr.fused_rollout(state, action, T, params, spec)
    _, st = pr.scan_rollout(state, action, key, env_ids, T, params, spec)
    np.testing.assert_array_equal(np.asarray(ft['episodes']),
                                  np.asarray(st['episodes']))

    res = profiling.steps_per_sec(
        lambda: pr.fused_rollout(state, action, T, params, spec)[1],
        B * T, reps=REPS)
    print(json.dumps({
        'metric': 'lander3d_env_steps_per_sec_4096envs_fused',
        'value': res['steps_per_sec'],
        'unit': 'env-steps/s',
        'spread_pct': res['spread_pct'],
        'device': device,
        'power_limit': power,
    }))


if __name__ == '__main__':
    main()
