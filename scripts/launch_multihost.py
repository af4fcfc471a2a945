#!/usr/bin/env python3
"""Multi-host PPO launcher: `jax.distributed.initialize` + global env mesh.

The reference is strictly single-process (SURVEY.md §2.3); this is the new
build's multi-host entry point.  Each host (process) owns a shard of the
global env batch along the 1-D `env` mesh axis; learner parameters are
replicated and the gradient all-reduce — the ONLY cross-host traffic, since
environments never communicate — is inserted by the SPMD partitioner
(NCCL between GPUs, Gloo between CPU processes).

Run one copy per host:

  python scripts/launch_multihost.py \
      --coordinator HOST0:1234 --num-processes N --process-id I \
      [--envs-per-host 1024] [--updates 20] [--env Hover3D-v0]

Works degenerately with N=1 (single host).  `tests/test_multihost.py`
exercises the real 2-process path on CPU devices over localhost.

Each process owns its devices alone: with `--platform cpu` every process
uses the CPU; otherwise process I opens only local GPU I
(`local_device_ids`), so N processes on one host use N cards and no two
processes open the same card.

Determinism note: per-env randomness is keyed by GLOBAL env id
(envs/base.py), so the N-host run reproduces the 1-host trajectories
bit-for-bit for the same global batch.
"""

import argparse
import json
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--coordinator', default=None,
                   help='host:port of process 0 (required for N>1)')
    p.add_argument('--num-processes', type=int, default=1)
    p.add_argument('--process-id', type=int, default=0)
    p.add_argument('--platform', default=None,
                   help="JAX platform (e.g. 'cpu' for the loopback demo)")
    p.add_argument('--env', default='Hover3D-v0')
    p.add_argument('--envs-per-host', type=int, default=1024)
    p.add_argument('--updates', type=int, default=20)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--out', default=None,
                   help='process 0 writes a JSON report here')
    args = p.parse_args()

    if args.platform:
        os.environ['JAX_PLATFORMS'] = args.platform

    import jax

    if args.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            local_device_ids=(None if args.platform == 'cpu'
                              else [args.process_id]))

    import numpy as np
    import jax.numpy as jnp

    from gym_copter_tpu.envs import tasks
    from gym_copter_tpu.envs.registry import default_params
    from gym_copter_tpu.learn import ppo
    from gym_copter_tpu.parallel import sharding as sh

    n_proc = jax.process_count()
    assert n_proc == args.num_processes, (n_proc, args.num_processes)
    mesh = sh.make_mesh()                     # global: all processes' devices
    n_dev = mesh.devices.size
    num_envs = args.envs_per_host * n_proc
    if args.process_id == 0:
        print(f'[multihost] {n_proc} processes, {n_dev} global devices, '
              f'{num_envs} global envs', flush=True)

    spec = tasks.ALL_TASKS[args.env]
    env_params = default_params()
    cfg = ppo.PPOConfig()
    base_key = jax.random.PRNGKey(args.seed + 1)
    env_ids = jnp.arange(num_envs, dtype=jnp.int32)

    train_step, optimizer = ppo.make_train_step(env_params, spec, cfg,
                                                base_key, env_ids)
    # every process computes the identical full initial state host-side
    # (same seeds), then assembles global arrays shard-by-shard — the
    # standard multi-process construction (device_put cannot address other
    # hosts' devices)
    ts = ppo.init_train_state(jax.random.PRNGKey(args.seed), env_params,
                              spec, cfg, num_envs, optimizer)

    def globalize(tree, sharding_of):
        def leaf(x):
            x = np.asarray(x)
            sharding = sharding_of(x)
            return jax.make_array_from_callback(
                x.shape, sharding, lambda idx: x[idx])
        return jax.tree.map(leaf, tree)

    ts = ppo.TrainState(
        params=globalize(ts.params, lambda x: sh.replicated(mesh)),
        opt_state=globalize(ts.opt_state, lambda x: sh.replicated(mesh)),
        env_state=globalize(
            ts.env_state, lambda x: sh.batched_sharding(mesh, x.ndim)),
        obs=globalize(ts.obs, lambda x: sh.batched_sharding(mesh, x.ndim)),
        key=globalize(ts.key, lambda x: sh.replicated(mesh)),
        update_idx=globalize(ts.update_idx, lambda x: sh.replicated(mesh)),
    )

    step = jax.jit(train_step, donate_argnums=0)
    ts, metrics = step(ts)                    # compile + first update
    jax.block_until_ready(metrics)
    t0 = time.perf_counter()
    for _ in range(args.updates - 1):
        ts, metrics = step(ts)
    metrics = {k: float(v) for k, v in metrics.items()}
    elapsed = time.perf_counter() - t0
    env_steps = (args.updates - 1) * num_envs * cfg.rollout_steps
    rate = env_steps / max(elapsed, 1e-9)

    report = {
        'processes': n_proc,
        'devices': n_dev,
        'global_envs': num_envs,
        'updates': args.updates,
        'env_steps_per_sec': rate,
        'reward_per_step': metrics['reward_per_step'],
        'update_idx': int(jax.device_get(
            jax.tree.leaves(ts.update_idx)[0])),
    }
    if args.process_id == 0:
        print('[multihost] ' + json.dumps(report), flush=True)
        if args.out:
            with open(args.out, 'w') as f:
                json.dump(report, f, indent=1)
    # orderly shutdown of the distributed service
    if args.num_processes > 1:
        jax.distributed.shutdown()


if __name__ == '__main__':
    main()
