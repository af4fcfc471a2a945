#!/usr/bin/env python3
"""On-card smoke test of the simulator's main path.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the multi-card path, on four cards

One card, at the sizes users run (4,096 envs, the flagship PPO recipe, and
262,144 envs):
  1. the fused rollout kernel against the XLA scan, Lander3D, 1,000 steps,
     deterministic resets and random resets;
  2. the public API (`gct.make`, `reset`, `rollout`) against the same
     rollout at 'highest' matmul precision;
  3. one PPO train step with library defaults against the same step at
     'highest' matmul precision;
  4. kernel and scan times, median of 20 calls (informational);
  5. compiled memory use of the kernel and the train step.
With --four-cards: the sharded kernel over four cards against one card, and
one PPO step with the env batch sharded over four cards (learner
replicated, gradients all-reduced) against one card.

Each phase prints its result on its own line; a failed check raises and the
script exits non-zero.  The last line, printed only when every phase
passed, is one JSON object: {"ok": true, "device": {"platform": ...,
"kind": ..., "count": ...}}.  Without a GPU the script exits non-zero and
prints no result.
"""

import argparse
import contextlib
import json
import subprocess
import sys

import numpy as np

T = 1000
BATCHES = (4096, 262144)
PPO_ENVS = 4096
SHARDED_ENVS = 4 * 65536
# episode cap in the random-reset checks, so that every env passes through
# several in-kernel resets (and their wind kicks) within T steps
RANDOM_RESET_MAX_STEPS = 200
THRUST = 1.625e-2  # the reference demo's constant motor value (lander.py:21)
TIMING_REPS = 20  # a 1 ms call needs many samples for a stable median
# Kernel vs scan reward sums: f32 sums over 1,000 steps whose per-step
# rewards may differ in the last bits (the two compilers contract and
# order the arithmetic differently); the state machine must still agree,
# so episode counts are compared exactly.
REWARD_RTOL, REWARD_ATOL = 2e-4, 2e-3
# Public-API rollout at default vs 'highest' precision: its only matmul is
# the motor mix, which is pinned to HIGHEST, so the two programs agree to
# rounding.
API_RTOL, API_ATOL = 1e-5, 1e-4
# PPO step at default precision (f32 dots may run in TF32 on the card) vs
# 'highest': relative L2 distance of the parameters after one update, and
# relative difference of the metrics that are not differences of nearly
# equal terms.  Measured on an H200: 5.1e-5 for the parameters, below
# 3e-6 for the metrics; the bound leaves 20x room.
PPO_PRECISION_TOL = 1e-3
# PPO step sharded over four cards vs one card, same measure: the same
# arithmetic with the gradient sums taken in another order, and matmuls on
# other shapes (so possibly other TF32 kernels).
PPO_MESH_TOL = 1e-3
PPO_METRICS = ('reward_per_step', 'episode_return_proxy', 'done_rate',
               'v_loss', 'entropy')


def _require(ok, what):
    """A failed check raises (and ends the run), also under `python -O`."""
    if not ok:
        raise AssertionError(what)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _tree_rel(ta, tb):
    import jax
    la = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(ta)]
    lb = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(tb)]
    return _rel(np.concatenate(la), np.concatenate(lb))


def _lander(force, max_steps=1000):
    from gym_copter_tpu.core import vehicles
    from gym_copter_tpu.core.types import EnvParams, TaskParams
    return EnvParams(vehicle=vehicles.DJI_PHANTOM,
                     task=TaskParams(initial_random_force=force,
                                     max_steps=max_steps))


def _varied_start(b, params, spec):
    """b Lander3D envs whose first episodes differ: a per-env wind kick
    drawn from the seed, and a per-env constant thrust on each motor
    around hover, so that envs land, crash, tilt and drift apart."""
    import jax
    import jax.numpy as jnp
    from gym_copter_tpu.envs import base

    k_force, k_act = jax.random.split(jax.random.PRNGKey(42))
    force = jnp.concatenate([
        jax.random.uniform(k_force, (3, b), minval=-30.0, maxval=30.0),
        jnp.zeros((3, b))])
    ids = jnp.arange(b, dtype=jnp.int32)
    state, _ = base.reset(jax.random.PRNGKey(0), ids,
                          jnp.zeros(b, jnp.int32), params, spec,
                          perturb_force=force)
    action = jax.random.uniform(k_act, (4, b), minval=0.0155,
                                maxval=0.0175)
    return state, action, ids


def kernel_parity():
    import jax
    import jax.numpy as jnp
    from gym_copter_tpu.envs import base, tasks
    from gym_copter_tpu.ops import pallas_rollout as pr

    spec = tasks.LANDER_3D
    params = _lander(0.0)
    key = jax.random.PRNGKey(0)
    for b in BATCHES:
        state, action, ids = _varied_start(b, params, spec)
        _, ft = pr.fused_rollout(state, action, T, params, spec)
        _, st = pr.scan_rollout(state, action, key, ids, T, params, spec)
        fe, se = np.asarray(ft['episodes']), np.asarray(st['episodes'])
        fr, sr = np.asarray(ft['reward_sum']), np.asarray(st['reward_sum'])
        _require(fe.min() >= 1, 'an env completed no episode')
        np.testing.assert_array_equal(fe, se, err_msg=f'episodes, b={b}')
        np.testing.assert_allclose(fr, sr, rtol=REWARD_RTOL,
                                   atol=REWARD_ATOL,
                                   err_msg=f'reward_sum, b={b}')
        print(f'phase 1 kernel parity b={b} T={T}: episodes equal on all '
              f'{b} envs (mean {fe.mean():.3f}), reward_sum max |diff| '
              f'{np.abs(fr - sr).max():.3g} (rtol {REWARD_RTOL}, atol '
              f'{REWARD_ATOL})', flush=True)

    params = _lander(30.0, RANDOM_RESET_MAX_STEPS)
    for b in BATCHES:
        ids = jnp.arange(b, dtype=jnp.int32)
        state, _ = base.reset(key, ids, jnp.zeros(b, jnp.int32), params,
                              spec)
        action = jnp.full((4, b), THRUST, jnp.float32)
        _, t1 = pr.fused_rollout(state, action, T, params, spec, seed=7)
        _, t2 = pr.fused_rollout(state, action, T, params, spec, seed=7)
        eps = np.asarray(t1['episodes'])
        _require(eps.min() >= 2, 'an env passed through no random reset')
        _require(np.isfinite(np.asarray(t1['reward_sum'])).all(),
                 'non-finite reward_sum')
        np.testing.assert_array_equal(np.asarray(t1['reward_sum']),
                                      np.asarray(t2['reward_sum']))
        np.testing.assert_array_equal(eps, np.asarray(t2['episodes']))
        print(f'phase 1 kernel random resets b={b} T={T}: every env '
              f'completed >= 2 episodes (mean {eps.mean():.3f}, cap '
              f'{RANDOM_RESET_MAX_STEPS} steps); same seed gives '
              f'bit-identical totals', flush=True)


def public_api():
    import jax
    import jax.numpy as jnp
    import gym_copter_tpu as gct

    b = PPO_ENVS

    def policy(_, obs):
        return None, jnp.full((4, b), THRUST, jnp.float32)

    def run():
        env = gct.make('Lander3D-v0', num_envs=b)
        state, _ = env.reset()
        final, _, traj = env.rollout(state, policy, T)
        return jax.device_get((final.dyn.x, traj.reward, traj.done))

    x, reward, done = run()
    with jax.default_matmul_precision('highest'):
        x_h, reward_h, done_h = run()
    _require(np.isfinite(x).all() and np.isfinite(reward).all(),
             'non-finite state or reward')
    _require(done.any(axis=0).all(), 'an env never terminated')
    np.testing.assert_array_equal(done, done_h)
    np.testing.assert_allclose(reward, reward_h, rtol=API_RTOL,
                               atol=API_ATOL)
    np.testing.assert_allclose(x, x_h, rtol=API_RTOL, atol=API_ATOL)
    print(f'phase 2 public API b={b} T={T}: {int(done.sum())} episodes '
          f'ended, every env terminated; matches highest precision, reward '
          f'max |diff| {np.abs(reward - reward_h).max():.3g}', flush=True)


def _ppo_step(mesh=None, precision=None):
    """One jitted PPO train step with library defaults on Lander3D at
    PPO_ENVS envs.  Returns (state before, state after, metrics, compiled
    step)."""
    import jax
    import jax.numpy as jnp
    from gym_copter_tpu.core import vehicles
    from gym_copter_tpu.core.types import EnvParams
    from gym_copter_tpu.envs import tasks
    from gym_copter_tpu.learn import ppo
    from gym_copter_tpu.parallel import sharding as sh

    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    spec = tasks.LANDER_3D
    cfg = ppo.PPOConfig()
    ids = jnp.arange(PPO_ENVS, dtype=jnp.int32)
    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:
        train_step, opt = ppo.make_train_step(params, spec, cfg,
                                              jax.random.PRNGKey(1), ids)
        ts = ppo.init_train_state(jax.random.PRNGKey(0), params, spec, cfg,
                                  PPO_ENVS, opt)
        if mesh is not None:
            ts = ts._replace(params=sh.replicate(ts.params, mesh),
                             opt_state=sh.replicate(ts.opt_state, mesh),
                             env_state=sh.shard_env_state(ts.env_state, mesh),
                             obs=sh.shard_env_state(ts.obs, mesh))
        step = jax.jit(train_step).lower(ts).compile()
        ts2, metrics = step(ts)
    return ts, jax.device_get(ts2), jax.device_get(metrics), step


def _check_ppo(ts, ts2, metrics, label):
    for k, v in metrics.items():
        _require(np.isfinite(v), f'{label}: non-finite metric {k}')
    _require(int(ts2.update_idx) == 1, f'{label}: update_idx != 1')
    moved = ((np.asarray(ts2.env_state.steps)
              != np.asarray(ts.env_state.steps))
             | (np.asarray(ts2.env_state.episode)
                != np.asarray(ts.env_state.episode)))
    _require(moved.all(), f'{label}: an env did not advance')


def _ppo_diff(a, ma, b, mb):
    diffs = {'params': _tree_rel(a.params, b.params)}
    for k in PPO_METRICS:
        diffs[k] = abs(float(ma[k]) - float(mb[k])) / max(abs(float(mb[k])),
                                                          1e-6)
    return diffs


def ppo_step():
    ts, ts2, metrics, step = _ppo_step()
    _check_ppo(ts, ts2, metrics, 'default precision')
    _, ts2_h, metrics_h, _ = _ppo_step(precision='highest')
    diffs = _ppo_diff(ts2, metrics, ts2_h, metrics_h)
    worst = max(diffs.values())
    print(f'phase 3 PPO train step b={PPO_ENVS}: metrics finite, every env '
          f'advanced, update_idx 1; largest relative difference vs highest '
          f'precision {worst:.3g} ('
          + ', '.join(f'{k} {v:.3g}' for k, v in diffs.items())
          + f'; tolerance {PPO_PRECISION_TOL})', flush=True)
    _require(worst < PPO_PRECISION_TOL, diffs)
    return step


def times():
    import jax
    from gym_copter_tpu.envs import tasks
    from gym_copter_tpu.ops import pallas_rollout as pr
    from gym_copter_tpu.utils import profiling

    spec = tasks.LANDER_3D
    params = _lander(0.0)
    key = jax.random.PRNGKey(0)
    compiled = None
    for b in BATCHES:
        state, action, ids = _varied_start(b, params, spec)
        fused = profiling.steps_per_sec(
            lambda: pr.fused_rollout(state, action, T, params, spec)[1],
            b * T, reps=TIMING_REPS)
        scan = profiling.steps_per_sec(
            lambda: pr.scan_rollout(state, action, key, ids, T, params,
                                    spec)[1], b * T, reps=TIMING_REPS)
        print(f'phase 4 times b={b} T={T} (median of {TIMING_REPS}): kernel '
              f'{fused["seconds"] * 1e3:.3f} ms ({fused["steps_per_sec"]:.4g}'
              f' env-steps/s, spread {fused["spread_pct"]:.2g}%), scan '
              f'{scan["seconds"] * 1e3:.3f} ms ({scan["steps_per_sec"]:.4g} '
              f'env-steps/s, spread {scan["spread_pct"]:.2g}%), kernel/scan '
              f'speedup {scan["seconds"] / fused["seconds"]:.3g}x',
              flush=True)
        compiled = jax.jit(
            lambda s, a: pr.fused_rollout(s, a, T, params, spec)
        ).lower(state, action).compile()
    return compiled


def memory(kernel, train_step):
    import jax

    for name, c in (('kernel b=%d' % BATCHES[-1], kernel),
                    ('PPO train step b=%d' % PPO_ENVS, train_step)):
        m = c.memory_analysis()
        print(f'phase 5 memory {name}: arguments '
              f'{m.argument_size_in_bytes} B, outputs '
              f'{m.output_size_in_bytes} B, temporaries '
              f'{m.temp_size_in_bytes} B', flush=True)
    peak = jax.devices()[0].memory_stats()['peak_bytes_in_use']
    print(f'phase 5 memory: peak_bytes_in_use {peak}', flush=True)


def sharded_rollout():
    import jax
    import jax.numpy as jnp
    from gym_copter_tpu.envs import base, tasks
    from gym_copter_tpu.ops import pallas_rollout as pr
    from gym_copter_tpu.parallel import sharding as sh

    spec = tasks.LANDER_3D
    params = _lander(30.0, RANDOM_RESET_MAX_STEPS)
    mesh = sh.make_mesh(jax.devices()[:4])
    b = SHARDED_ENVS
    ids = jnp.arange(b, dtype=jnp.int32)
    state, _ = base.reset(jax.random.PRNGKey(0), ids,
                          jnp.zeros(b, jnp.int32), params, spec)
    action = jnp.full((4, b), THRUST, jnp.float32)
    out4, tot4 = sh.sharded_fused_rollout(
        sh.shard_env_state(state, mesh), sh.shard_env_state(action, mesh),
        T, params, spec, mesh, seed=7)
    out1, tot1 = pr.fused_rollout(state, action, T, params, spec, seed=7)
    eps = np.asarray(tot4['episodes'])
    _require(eps.min() >= 2, 'an env passed through no random reset')
    for name, a, b_ in (('x', out4.dyn.x, out1.dyn.x),
                        ('episodes', tot4['episodes'], tot1['episodes']),
                        ('reward_sum', tot4['reward_sum'],
                         tot1['reward_sum'])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_),
                                      err_msg=name)
    print(f'four cards: sharded kernel b={b} T={T} random resets: totals '
          f'and final state bit-identical to one card (mean episodes '
          f'{eps.mean():.3f})', flush=True)


def sharded_ppo():
    import jax
    from gym_copter_tpu.parallel import sharding as sh

    mesh = sh.make_mesh(jax.devices()[:4])
    ts, ts2_4, m4, _ = _ppo_step(mesh=mesh)
    _check_ppo(ts, ts2_4, m4, 'four cards')
    _, ts2_1, m1, _ = _ppo_step()
    diffs = _ppo_diff(ts2_4, m4, ts2_1, m1)
    worst = max(diffs.values())
    print(f'four cards: PPO train step b={PPO_ENVS} sharded over 4 cards: '
          f'metrics finite; largest relative difference vs one card '
          f'{worst:.3g} (' + ', '.join(f'{k} {v:.3g}'
                                       for k, v in diffs.items())
          + f'; tolerance {PPO_MESH_TOL})', flush=True)
    _require(worst < PPO_MESH_TOL, diffs)


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--four-cards', action='store_true',
                   help='run only the multi-card path, on four cards')
    args = p.parse_args()

    import jax
    if jax.default_backend() != 'gpu':
        sys.exit(f'chip_smoke: no GPU found (JAX backend '
                 f'{jax.default_backend()!r})')
    from gym_copter_tpu.utils import compile_cache
    compile_cache.enable()
    need = 4 if args.four_cards else 1
    if len(jax.devices()) < need:
        sys.exit(f'chip_smoke: needs {need} GPUs, found '
                 f'{len(jax.devices())}')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)

    if args.four_cards:
        sharded_rollout()
        sharded_ppo()
    else:
        kernel_parity()
        public_api()
        train_step = ppo_step()
        kernel = times()
        memory(kernel, train_step)

    dev = jax.devices()[0]
    print(json.dumps({'ok': True, 'device': {'platform': dev.platform,
                                             'kind': dev.device_kind,
                                             'count': len(jax.devices())}}))


if __name__ == '__main__':
    main()
