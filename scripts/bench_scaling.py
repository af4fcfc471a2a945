#!/usr/bin/env python3
"""CPU scaling harness: the sharding machinery without accelerators.

Records in one JSON report:

  1. cpu_weak_scaling — the jitted scan path on a virtual CPU mesh at a
     fixed per-device batch, 1 -> 2 devices (2 virtual devices on 2
     physical cores; beyond the core count virtual devices timeshare cores
     and the numbers would measure the scheduler, not the sharding);
  2. cpu_concurrent_independent — two independent single-device processes
     at once, the control for host contention;
  3. multiprocess_loopback — a 2-process `jax.distributed` world over
     loopback (scripts/launch_multihost.py).

Every process runs on the CPU (JAX_PLATFORMS=cpu), so no two processes
ever open one GPU.  Each sub-measurement runs in its own subprocess because
the platform and virtual-device count must be fixed before JAX
initializes.

Usage: python scripts/bench_scaling.py [--out scaling.json]
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)

B_PER_DEV_CPU = 1024
T_CPU = 1000


def _mode_cpu(n_devices):
    import jax
    import jax.numpy as jnp

    from gym_copter_tpu.core import vehicles
    from gym_copter_tpu.core.types import EnvParams
    from gym_copter_tpu.envs import base, tasks
    from gym_copter_tpu.ops import pallas_rollout as pr
    from gym_copter_tpu.parallel import sharding as sh
    from gym_copter_tpu.utils import compile_cache, profiling

    compile_cache.enable()
    devices = jax.devices()
    assert len(devices) >= n_devices, (len(devices), n_devices)
    mesh = sh.make_mesh(devices[:n_devices])

    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    spec = tasks.LANDER_3D
    key = jax.random.PRNGKey(0)
    b = B_PER_DEV_CPU * n_devices
    env_ids = jnp.arange(b, dtype=jnp.int32)
    state, _ = base.reset(key, env_ids, jnp.zeros(b, jnp.int32), params, spec)
    action = jnp.full((4, b), 1.625e-2, jnp.float32)
    state = sh.shard_env_state(state, mesh)
    action = sh.shard_env_state(action, mesh)
    env_ids = sh.shard_env_state(env_ids, mesh)

    res = profiling.steps_per_sec(
        lambda: pr.scan_rollout(state, action, key, env_ids, T_CPU, params,
                                spec)[1], b * T_CPU, reps=4)
    print(json.dumps({'devices': n_devices,
                      'steps_per_sec': res['steps_per_sec'],
                      'per_device': res['steps_per_sec'] / n_devices}))


def _sub(args, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('XLA_FLAGS', None)
    if extra_env:
        env.update(extra_env)
    out = subprocess.run([sys.executable, os.path.abspath(__file__)] + args,
                         env=env, capture_output=True, text=True,
                         timeout=1800)
    if out.returncode != 0:
        raise RuntimeError(f'{args}: {out.stderr[-2000:]}')
    return json.loads(out.stdout.strip().splitlines()[-1])


def orchestrate(out_path):
    report = {'host_physical_cores': os.cpu_count()}

    # 1. CPU weak scaling, 1 -> 2 devices (= physical cores)
    cpu = []
    for n in (1, 2):
        cpu.append(_sub(
            ['--mode', 'cpu', '--devices', str(n)],
            {'XLA_FLAGS': f'--xla_force_host_platform_device_count={n}',
             'JAX_PLATFORMS': 'cpu'}))
    base_rate = cpu[0]['per_device']
    for row in cpu:
        row['efficiency'] = row['per_device'] / base_rate
    report['cpu_weak_scaling'] = cpu
    report['cpu_weak_scaling_note'] = (
        'capped at 2 virtual devices = physical cores; beyond that virtual '
        'devices timeshare cores and the ratio measures the OS scheduler')

    # 2. control experiment for the <100% point above: TWO INDEPENDENT
    # single-device processes running concurrently (no mesh, no shard_map,
    # no partitioner).  If their combined throughput shows the same
    # efficiency loss, the loss is the 2-core HOST (all-core turbo clocks,
    # shared memory bandwidth, runtime threads competing with compute) —
    # not the sharding machinery.
    try:
        env = dict(os.environ)
        env.pop('XLA_FLAGS', None)
        env.update({'XLA_FLAGS': '--xla_force_host_platform_device_count=1',
                    'JAX_PLATFORMS': 'cpu'})
        cmd = [sys.executable, os.path.abspath(__file__),
               '--mode', 'cpu', '--devices', '1']
        procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                  text=True) for _ in range(2)]
        outs = [json.loads(p.communicate(timeout=1800)[0]
                           .strip().splitlines()[-1]) for p in procs]
        pair_rate = sum(o['steps_per_sec'] for o in outs) / 2
        report['cpu_concurrent_independent'] = {
            'per_process_rates': [o['steps_per_sec'] for o in outs],
            'mean_per_process': pair_rate,
            'efficiency_vs_solo': pair_rate / base_rate,
        }
        sharded_eff = cpu[1]['efficiency']
        indep_eff = pair_rate / base_rate
        if sharded_eff >= indep_eff:
            verdict = (
                'the one-process sharded mesh is at least as efficient as '
                'two independent runtimes — the mesh/partitioner adds NO '
                'overhead; whatever efficiency is lost at 2 devices is '
                'host-hardware contention (all-core turbo, shared memory '
                'bandwidth, duplicated XLA runtime threads)')
        else:
            verdict = (
                f'the mesh/partitioner accounts for at most '
                f'{indep_eff - sharded_eff:.3f} of the loss; the rest is '
                'host-hardware contention')
        report['cpu_weak_scaling_analysis'] = (
            f'sharded 2-device weak-scaling efficiency {sharded_eff:.3f}; '
            f'two INDEPENDENT single-device processes (no mesh, no '
            f'partitioner) reach only {indep_eff:.3f} each: {verdict}.')
    except Exception as e:  # noqa: BLE001
        report['cpu_concurrent_independent'] = {'error': str(e)[-500:]}

    # 3. jax.distributed over loopback.  A 1-process
    # baseline at the same per-process env count gives the per-process
    # efficiency ratio of going multi-process (VERDICT round-2 item 9).
    try:
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            env = dict(os.environ)
            env.pop('XLA_FLAGS', None)

            solo_out = os.path.join(td, 'solo.json')
            solo_cmd = [sys.executable,
                        os.path.join(REPO, 'scripts', 'launch_multihost.py'),
                        '--num-processes', '1', '--platform', 'cpu',
                        '--envs-per-host', '512', '--updates', '5',
                        '--out', solo_out]
            assert subprocess.run(solo_cmd, env=env,
                                  stdout=subprocess.DEVNULL,
                                  timeout=900).returncode == 0
            with open(solo_out) as f:
                solo = json.load(f)

            mh_out = os.path.join(td, 'mh.json')
            procs = []
            port = 24000 + os.getpid() % 2000
            for pid in range(2):
                cmd = [sys.executable,
                       os.path.join(REPO, 'scripts', 'launch_multihost.py'),
                       '--num-processes', '2', '--process-id', str(pid),
                       '--coordinator', f'localhost:{port}',
                       '--platform', 'cpu', '--envs-per-host', '512',
                       '--updates', '5']
                if pid == 0:
                    cmd += ['--out', mh_out]
                procs.append(subprocess.Popen(cmd, env=env,
                                              stdout=subprocess.DEVNULL,
                                              stderr=subprocess.DEVNULL))
            for pr_ in procs:
                assert pr_.wait(timeout=900) == 0
            with open(mh_out) as f:
                duo = json.load(f)
            report['multiprocess_loopback'] = {
                'one_process': solo,
                'two_process': duo,
                'per_process_efficiency': (
                    (duo['env_steps_per_sec'] / duo['processes'])
                    / solo['env_steps_per_sec']),
                'note': ('two loopback processes share the same 2 CPU '
                         'cores, so this ratio compounds the host-'
                         'contention effect quantified by '
                         'cpu_concurrent_independent with the gradient '
                         'all-reduce cost.  Rollouts need no collectives '
                         '(env shards are independent, keyed by global env '
                         'id), so cross-process traffic is one gradient '
                         'all-reduce per minibatch step.'),
            }
    except Exception as e:  # noqa: BLE001
        report['multiprocess_loopback'] = {'error': str(e)[-500:]}

    with open(out_path, 'w') as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--mode', default=None, choices=[None, 'cpu'])
    p.add_argument('--devices', type=int, default=1)
    p.add_argument('--out', default='scaling.json')
    args = p.parse_args()
    if args.mode == 'cpu':
        _mode_cpu(args.devices)
    else:
        orchestrate(args.out)


if __name__ == '__main__':
    main()
