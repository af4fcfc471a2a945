"""Multi-host (multi-process) training over jax.distributed.

Spawns REAL separate processes connected through the distributed service
(Gloo over loopback) and
checks: both processes complete, the global mesh spans both processes'
devices, and — the determinism contract (envs/base.py keys randomness by
GLOBAL env id) — the 2-host run reproduces the single-host run's training
metrics exactly for the same global batch.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, 'scripts', 'launch_multihost.py')

ENVS_PER_HOST = 64
UPDATES = 3


def _run_world(num_processes, port, out_path, envs_per_host):
    """Launch an N-process world; returns process-0's JSON report."""
    env = dict(os.environ)
    env.pop('XLA_FLAGS', None)               # no virtual-device inflation
    procs = []
    for pid in range(num_processes):
        cmd = [sys.executable, SCRIPT,
               '--num-processes', str(num_processes),
               '--process-id', str(pid),
               '--coordinator', f'localhost:{port}',
               '--platform', 'cpu',
               '--envs-per-host', str(envs_per_host),
               '--updates', str(UPDATES)]
        if pid == 0:
            cmd += ['--out', out_path]
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out.decode()[-2000:]
    with open(out_path) as f:
        return json.load(f)


@pytest.mark.slow
def test_two_process_world_matches_single_host(tmp_path):
    port = 23000 + os.getpid() % 2000

    # 2 processes x 64 envs each = 128 global envs
    two = _run_world(2, port, str(tmp_path / 'two.json'), ENVS_PER_HOST)
    assert two['processes'] == 2
    assert two['devices'] == 2
    assert two['global_envs'] == 2 * ENVS_PER_HOST
    assert two['update_idx'] == UPDATES

    # 1 process x 128 envs = the same global batch
    one = _run_world(1, port + 1, str(tmp_path / 'one.json'),
                     2 * ENVS_PER_HOST)
    assert one['processes'] == 1
    assert one['global_envs'] == two['global_envs']

    # determinism across layouts: identical training metrics
    assert one['reward_per_step'] == two['reward_per_step']
