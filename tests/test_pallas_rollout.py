"""Fused Pallas rollout kernel vs the XLA scan path.

With `initial_random_force == 0` both paths are fully deterministic, so the
kernel (run in the Pallas interpreter on the CPU test backend) must
reproduce the scan path's state trajectory BIT-EXACTLY — same dynamics op
order, same status machine, same auto-reset.  The compiled GPU kernel is
checked against the scan on the card by chip_smoke.py; here it is lowered
for CUDA without a card.  Rewards/shaping are compared to tight
tolerance (the kernel sums squares sequentially where the XLA path uses a
reduce, so the last ulp may differ; reward never feeds back into state).

Scenario coverage of the branchless status machine (SURVEY.md §2.4):
  * hover from tilted pose   -> tilt termination + auto-reset
  * lander, max_steps cap    -> truncation + auto-reset
  * lander, soft descent     -> touchdown -> LEVELING -> LANDED -> bonus
  * lander, free fall        -> touchdown + crash -> CRASHED
  * 1D variant               -> broadcast motor mix
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_copter_tpu.core import constants as C
from gym_copter_tpu.core import vehicles
from gym_copter_tpu.core.types import EnvParams, TaskParams
from gym_copter_tpu.envs import base, tasks
from gym_copter_tpu.ops import pallas_rollout as pr

B = 128


def _params(max_steps=60, **kw):
    # force = 0 -> deterministic resets, bit-comparable paths
    return EnvParams(vehicle=vehicles.DJI_PHANTOM,
                     task=TaskParams(initial_random_force=0.0,
                                     max_steps=max_steps, **kw))


def _run_both(spec, params, action, num_steps, pose=None, b=B):
    key = jax.random.PRNGKey(0)
    env_ids = jnp.arange(b, dtype=jnp.int32)
    ep0 = jnp.zeros(b, jnp.int32)
    state, _ = base.reset(key, env_ids, ep0, params, spec, pose=pose,
                          dtype=jnp.float32)
    action = jnp.broadcast_to(
        jnp.asarray(action, jnp.float32)[:, None], (spec.action_size, b))

    fused_state, fused_tot = pr.fused_rollout(
        state, action, num_steps, params, spec, interpret=True)
    scan_state, scan_tot = pr.scan_rollout(
        state, action, key, env_ids, num_steps, params, spec)
    return (fused_state, fused_tot), (scan_state, scan_tot)


def _assert_match(fused, scan, scenario):
    (fs, ft), (ss, st) = fused, scan
    np.testing.assert_array_equal(np.asarray(fs.dyn.x),
                                  np.asarray(ss.dyn.x),
                                  err_msg=f'{scenario}: state x')
    np.testing.assert_array_equal(np.asarray(fs.dyn.status),
                                  np.asarray(ss.dyn.status),
                                  err_msg=f'{scenario}: status')
    np.testing.assert_array_equal(np.asarray(fs.dyn.perturb),
                                  np.asarray(ss.dyn.perturb),
                                  err_msg=f'{scenario}: perturb')
    np.testing.assert_array_equal(np.asarray(fs.dyn.ticks),
                                  np.asarray(ss.dyn.ticks),
                                  err_msg=f'{scenario}: ticks')
    np.testing.assert_array_equal(np.asarray(fs.steps), np.asarray(ss.steps),
                                  err_msg=f'{scenario}: steps')
    np.testing.assert_array_equal(np.asarray(fs.episode),
                                  np.asarray(ss.episode),
                                  err_msg=f'{scenario}: episode')
    np.testing.assert_array_equal(np.asarray(ft['episodes']),
                                  np.asarray(st['episodes']),
                                  err_msg=f'{scenario}: episodes')
    np.testing.assert_allclose(np.asarray(fs.prev_shaping),
                               np.asarray(ss.prev_shaping),
                               rtol=1e-6, atol=1e-5,
                               err_msg=f'{scenario}: prev_shaping')
    np.testing.assert_allclose(np.asarray(ft['reward_sum']),
                               np.asarray(st['reward_sum']),
                               rtol=1e-5, atol=1e-3,
                               err_msg=f'{scenario}: reward_sum')


def test_lander3d_truncation_parity():
    """Demo-heuristic thrust from 10 m; max_steps=60 forces >=2 auto-resets
    in 150 steps."""
    fused, scan = _run_both(tasks.LANDER_3D, _params(max_steps=60),
                            [1.625e-2] * 4, 150)
    _assert_match(fused, scan, 'lander3d truncation')
    assert int(np.asarray(fused[1]['episodes'])[0]) >= 2


def test_hover3d_tilt_termination_parity():
    """40-degree initial roll at hover thrust drifts out of bounds (~156
    steps at g*tan(40) lateral acceleration) well before the step cap."""
    fused, scan = _run_both(tasks.HOVER_3D, _params(max_steps=400),
                            [1.66e-2] * 4, 250, pose=(0.0, 0.0, 10.0, 40.0, 0.0))
    _assert_match(fused, scan, 'hover3d tilt')
    assert int(np.asarray(fused[1]['episodes'])[0]) >= 1


def test_lander3d_soft_landing_parity():
    """Slightly-below-hover thrust from 0.5 m: touchdown with |dz| < 1 walks
    the LEVELING -> LANDED path and collects the inside-radius bonus."""
    spec = tasks.LANDER_3D._replace(start_altitude=0.5)
    fused, scan = _run_both(spec, _params(max_steps=400), [1.625e-2] * 4, 300)
    _assert_match(fused, scan, 'lander3d soft landing')
    # the landing bonus must have been paid at least once
    assert float(np.asarray(fused[1]['reward_sum'])[0]) > 50.0
    assert int(np.asarray(fused[1]['episodes'])[0]) >= 1


def test_lander3d_crash_parity():
    """Zero thrust from 0.5 m free-falls past the 1 m/s touchdown limit:
    CRASHED status, crash termination, auto-reset loop."""
    spec = tasks.LANDER_3D._replace(start_altitude=0.5)
    fused, scan = _run_both(spec, _params(max_steps=400), [0.0] * 4, 100)
    _assert_match(fused, scan, 'lander3d crash')
    assert int(np.asarray(fused[1]['episodes'])[0]) >= 2


def test_lander1d_mix_parity():
    """1-motor action broadcast through the 1D mix matrix."""
    fused, scan = _run_both(tasks.LANDER_1D, _params(max_steps=50),
                            [1.625e-2], 120)
    _assert_match(fused, scan, 'lander1d')


@pytest.mark.parametrize('throttle,scenario', [
    (0.48, 'descent'),    # just below attic hover (~0.52): soft landing path
    (-1.0, 'free-fall'),  # zero motors: crash + repeated auto-reset
])
def test_lander3d_simple_parity(throttle, scenario):
    """Lander3DSimple through the fused kernel (VERDICT round-2 item 4):
    demand3 pre/post-mix clipping, 'simple' termination (oob/tilt REPLACE,
    bonus after, squared inside compare), the fixed +2.5 X/Y start, and the
    integrate_on_reset free-fall constants — bit-exact vs the XLA scan on
    its own 50 Hz attic-vehicle preset."""
    from gym_copter_tpu.envs.tasks import (LANDER_3D_SIMPLE,
                                           _simple_lander_params)
    params = _simple_lander_params()
    params = params._replace(task=params.task._replace(max_steps=120))
    fused, scan = _run_both(LANDER_3D_SIMPLE, params,
                            [throttle, 0.0, 0.0], 300)
    _assert_match(fused, scan, f'lander3d-simple {scenario}')
    assert int(np.asarray(fused[1]['episodes'])[0]) >= 1


def test_unsupported_spec_raises():
    bogus = tasks.TARGET._replace(kind='nope')
    with pytest.raises(ValueError, match='fused-kernel family'):
        state, _ = base.reset(jax.random.PRNGKey(0),
                              jnp.arange(B, dtype=jnp.int32),
                              jnp.zeros(B, jnp.int32),
                              _params(), tasks.TARGET)
        pr.fused_rollout(state, jnp.zeros((4, B)), 10, _params(), bogus)


@pytest.mark.parametrize('spec_name,action', [
    ('ALTHOLD', [0.1]),        # rescale01, holds near 10 m
    ('TAKEOFF', [0.02] * 4),   # raw motors, grounded start
    ('DISTANCE', [0.02] * 4),  # raw motors, shaping delta
    ('TARGET', [0.0] * 4),     # rescale01 -> motors 0.5, climbs, step cap
])
def test_aux_task_parity(spec_name, action):
    """AltHold / Takeoff / Distance / Target kinds through the fused
    kernel: bit-exact against the XLA scan path (deterministic mode)."""
    spec = getattr(tasks, spec_name)
    fused, scan = _run_both(spec, _params(max_steps=80), action, 200)
    _assert_match(fused, scan, spec_name.lower())


def test_target_crash_only_termination_parity():
    """Target crash path: free fall from 8 m hits the ground with dz > 1 ->
    STATUS_CRASHED -> crash_only done -> auto-reset to the grounded start
    (attic target.py:41-42 semantics)."""
    fused, scan = _run_both(tasks.TARGET, _params(max_steps=900),
                            [-1.0] * 4, 250, pose=(0.0, 0.0, 8.0, 0.0, 0.0))
    _assert_match(fused, scan, 'target-crash')
    _, ft = fused
    assert int(jnp.min(ft['episodes'])) >= 1


@pytest.mark.parametrize('b', [100, 1000])
def test_batch_tail_parity(b):
    """Batches that are not a multiple of the kernel's env block: the
    masked tail block must match the scan lane for lane."""
    assert b % pr.BLOCK != 0
    fused, scan = _run_both(tasks.LANDER_3D, _params(max_steps=60),
                            [1.625e-2] * 4, 150, b=b)
    _assert_match(fused, scan, f'tail b={b}')
    assert fused[1]['episodes'].shape == (b,)


@pytest.mark.parametrize('b', [1000, 4096, 262144])
def test_kernel_lowers_for_cuda(b):
    """The Triton-route kernel lowers for CUDA without a card: one
    `pallas_call` custom call whose grid covers the batch in blocks."""
    params = _params(max_steps=60)
    spec = tasks.LANDER_3D
    state = jax.eval_shape(
        lambda: base.reset(jax.random.PRNGKey(0),
                           jnp.arange(b, dtype=jnp.int32),
                           jnp.zeros(b, jnp.int32), params, spec,
                           dtype=jnp.float32)[0])
    action = jax.ShapeDtypeStruct((4, b), jnp.float32)
    lowered = jax.jit(
        lambda st, a: pr.fused_rollout(st, a, 1000, params, spec)
    ).trace(state, action).lower(lowering_platforms=('cuda',))
    text = lowered.as_text()
    assert text.count('@__gpu$xla.gpu.triton') == 1
    grid = -(-b // pr.BLOCK)
    assert f'grid_x = {grid} : i32' in text


def test_sharded_fused_rollout_matches_unsharded():
    """fused kernel under shard_map on the 8-device CPU mesh: sharding the
    env batch must not change a single bit (deterministic mode)."""
    from gym_copter_tpu.parallel import sharding as sh

    n_dev = len(jax.devices())
    big = n_dev * 128
    params = _params(max_steps=60)
    spec = tasks.LANDER_3D
    key = jax.random.PRNGKey(0)
    env_ids = jnp.arange(big, dtype=jnp.int32)
    state, _ = base.reset(key, env_ids, jnp.zeros(big, jnp.int32), params,
                          spec, dtype=jnp.float32)
    action = jnp.full((4, big), 1.625e-2, jnp.float32)

    mesh = sh.make_mesh()
    sharded_state = sh.shard_env_state(state, mesh)
    s_out, s_tot = sh.sharded_fused_rollout(
        sharded_state, sh.shard_env_state(action, mesh), 150, params, spec,
        mesh, interpret=True)
    u_out, u_tot = pr.fused_rollout(state, action, 150, params, spec,
                                    interpret=True)
    np.testing.assert_array_equal(np.asarray(s_out.dyn.x),
                                  np.asarray(u_out.dyn.x))
    np.testing.assert_array_equal(np.asarray(s_tot['episodes']),
                                  np.asarray(u_tot['episodes']))
    np.testing.assert_array_equal(np.asarray(s_tot['reward_sum']),
                                  np.asarray(u_tot['reward_sum']))


@pytest.mark.parametrize('n_shards', [1, 2, 4, 8])
def test_sharded_random_reset_layout_independent(n_shards):
    """THE layout-independence contract (envs/base.py:16-19), with reset
    randomness ON: `sharded_fused_rollout` with initial_random_force=30 must
    be bit-identical on 1/2/4/8-shard meshes, because the reset kicks are a
    counter hash of (GLOBAL env id, episode, seed) — never of lane position,
    shard index, or a per-launch PRNG (VERDICT round-2 item 2)."""
    from gym_copter_tpu.parallel import sharding as sh

    if len(jax.devices()) < n_shards:
        pytest.skip('needs %d virtual devices' % n_shards)
    big = 8 * 128
    params = EnvParams(vehicle=vehicles.DJI_PHANTOM,
                       task=TaskParams(initial_random_force=30.0,
                                       max_steps=60))
    spec = tasks.LANDER_3D
    key = jax.random.PRNGKey(0)
    env_ids = jnp.arange(big, dtype=jnp.int32)
    state, _ = base.reset(key, env_ids, jnp.zeros(big, jnp.int32), params,
                          spec, dtype=jnp.float32)
    action = jnp.full((4, big), 1.625e-2, jnp.float32)

    u_out, u_tot = pr.fused_rollout(state, action, 150, params, spec,
                                    seed=7, interpret=True)
    # the test must bite: episodes reset in-kernel, and the in-kernel kick
    # path is live — a different seed (which feeds ONLY the kick hash in
    # this kernel) must change the trajectory
    assert int(jnp.min(u_tot['episodes'])) >= 1
    alt_out, _ = pr.fused_rollout(state, action, 150, params, spec,
                                  seed=8, interpret=True)
    assert not np.array_equal(np.asarray(u_out.dyn.x),
                              np.asarray(alt_out.dyn.x))

    mesh = sh.make_mesh(jax.devices()[:n_shards])
    s_out, s_tot = sh.sharded_fused_rollout(
        sh.shard_env_state(state, mesh),
        sh.shard_env_state(action, mesh), 150, params, spec,
        mesh, seed=7, interpret=True)
    for name, a, b_ in (('x', s_out.dyn.x, u_out.dyn.x),
                        ('perturb', s_out.dyn.perturb, u_out.dyn.perturb),
                        ('status', s_out.dyn.status, u_out.dyn.status),
                        ('episode', s_out.episode, u_out.episode),
                        ('reward', s_tot['reward_sum'], u_tot['reward_sum']),
                        ('episodes', s_tot['episodes'], u_tot['episodes'])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_),
                                      err_msg=f'{n_shards} shards: {name}')


def test_kick_hash_uniformity():
    """The in-kernel reset-kick stream `_kick_u01` is a decent U[0,1):
    correct first/second moments, full-range coverage, decorrelated across
    the three axes and across consecutive episodes."""
    n = 1 << 14
    eid = jnp.arange(n, dtype=jnp.int32)
    ep = jnp.ones((n,), jnp.int32)
    salt = jnp.int32(123)
    draws = [np.asarray(pr._kick_u01(eid, ep, salt, ax, jnp.float32))
             for ax in pr._KICK_AXIS]
    for d in draws:
        assert abs(d.mean() - 0.5) < 0.01
        assert abs(d.std() - (1 / np.sqrt(12))) < 0.01
        assert d.min() < 0.01 and d.max() > 0.99
    # axis decorrelation
    assert abs(np.corrcoef(draws[0], draws[1])[0, 1]) < 0.05
    # episode-to-episode decorrelation for a fixed env
    d_ep = np.asarray(pr._kick_u01(jnp.zeros(n, jnp.int32),
                                   jnp.arange(n, dtype=jnp.int32), salt,
                                   pr._KICK_AXIS[0], jnp.float32))
    assert abs(np.corrcoef(d_ep[:-1], d_ep[1:])[0, 1]) < 0.05
    # salt changes the stream
    d2 = np.asarray(pr._kick_u01(eid, ep, jnp.int32(124), pr._KICK_AXIS[0],
                                 jnp.float32))
    assert np.mean(draws[0] == d2) < 0.01


def test_sharded_fused_rollout_batch_check():
    """The sharded kernel needs only a batch that divides by the mesh:
    96 envs over 8 devices (12 each, a masked partial block per shard)
    match the unsharded kernel; 100 envs are refused."""
    from gym_copter_tpu.parallel import sharding as sh
    params = _params()
    mesh = sh.make_mesh()
    n_dev = len(jax.devices())
    assert n_dev == 8
    for b in (96, 100):
        state, _ = base.reset(jax.random.PRNGKey(0),
                              jnp.arange(b, dtype=jnp.int32),
                              jnp.zeros(b, jnp.int32), params,
                              tasks.LANDER_3D, dtype=jnp.float32)
        action = jnp.full((4, b), 1.625e-2, jnp.float32)
        if b % n_dev:
            with pytest.raises(ValueError, match='mesh size'):
                sh.sharded_fused_rollout(state, action, 10, params,
                                         tasks.LANDER_3D, mesh,
                                         interpret=True)
            continue
        s_out, s_tot = sh.sharded_fused_rollout(
            sh.shard_env_state(state, mesh), sh.shard_env_state(action, mesh),
            90, params, tasks.LANDER_3D, mesh, interpret=True)
        u_out, u_tot = pr.fused_rollout(state, action, 90, params,
                                        tasks.LANDER_3D, interpret=True)
        np.testing.assert_array_equal(np.asarray(s_out.dyn.x),
                                      np.asarray(u_out.dyn.x))
        np.testing.assert_array_equal(np.asarray(s_tot['reward_sum']),
                                      np.asarray(u_tot['reward_sum']))


@pytest.mark.parametrize('platform,kind,path', [
    ('cpu', 'Lander3D-v0', 'scan'),
    ('gpu', 'Lander3D-v0', 'fused'),
    ('gpu', 'Target-v0', 'fused'),
    ('cpu', 'Target-v0', 'scan'),
])
def test_rollout_path_by_platform(platform, kind, path):
    from gym_copter_tpu.envs import registry
    spec = tasks.ALL_TASKS[kind]
    assert registry.rollout_path(platform, _params(), spec) == path
    bogus = spec._replace(kind='nope')
    assert registry.rollout_path(platform, _params(), bogus) == 'scan'


def test_copter_env_fused_rollout_handle(monkeypatch):
    """Public handle path: on the CPU env.fused_rollout runs the XLA scan
    and says so; on the GPU it dispatches to the kernel (exercised here by
    reporting 'gpu' and running the kernel in the interpreter), and both
    give the same totals in deterministic mode, for any batch size."""
    import functools

    import gym_copter_tpu as gct
    from gym_copter_tpu.envs import registry

    env = gct.make('Hover3D-v0', num_envs=B,
                   params=_params(max_steps=30), seed=0)
    state, _ = env.reset()
    action = jnp.full((4, B), 1.66e-2, jnp.float32)
    _, tot = env.fused_rollout(state, action, 90)
    assert tot['path'] == 'scan'
    assert int(jnp.min(tot['episodes'])) >= 2   # 30-step cap, 90 steps

    monkeypatch.setattr(registry.jax, 'default_backend', lambda: 'gpu')
    monkeypatch.setattr(pr, 'fused_rollout',
                        functools.partial(pr.fused_rollout, interpret=True))
    _, ftot = env.fused_rollout(state, action, 90)
    assert ftot['path'] == 'fused'
    np.testing.assert_array_equal(np.asarray(ftot['episodes']),
                                  np.asarray(tot['episodes']))
    np.testing.assert_array_equal(np.asarray(ftot['reward_sum']),
                                  np.asarray(tot['reward_sum']))
    # any batch size takes the kernel, Target included
    tenv = gct.make('Target-v0', num_envs=16, params=_params(max_steps=30))
    ts_, _ = tenv.reset()
    _, ttot = tenv.fused_rollout(ts_, jnp.zeros((4, 16)), 40)
    assert ttot['path'] == 'fused'
    assert ttot['episodes'].shape == (16,)
