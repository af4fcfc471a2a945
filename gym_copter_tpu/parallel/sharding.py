"""Device-mesh sharding for batched environments and learners.

The reference has no parallelism of any kind (one env object, one process —
SURVEY.md §2.3); this module is the new build's scaling layer.  Environments
are embarrassingly parallel, so the design is pure data parallelism over a
1-D `env` mesh axis:

  * every (…, B) leaf of the env state is sharded along its batch (lane)
    axis; the jitted step partitions with zero communication;
  * learner parameters are replicated; the only collectives are the
    all-reduce of gradients (inserted automatically by the SPMD
    partitioner when a replicated output is computed from sharded inputs;
    NCCL between GPUs);
  * per-env randomness is keyed by *global* env id (envs/base.py), so any
    sharding layout reproduces the single-device trajectories bit-exactly.

Multi-host: call `jax.distributed.initialize()` before `make_mesh()`; the
mesh then spans all processes' devices and `env_id_offset` gives each
host's shard its global id range.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = 'env'


def make_mesh(devices: Optional[Sequence] = None, axis: str = ENV_AXIS) -> Mesh:
    """1-D mesh over all (local or global) devices for env-batch sharding."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def env_sharding(mesh: Mesh, axis: str = ENV_AXIS) -> NamedSharding:
    """Sharding for a (B,) per-env leaf."""
    return NamedSharding(mesh, P(axis))


def batched_sharding(mesh: Mesh, ndim: int, axis: str = ENV_AXIS) -> NamedSharding:
    """Sharding for a (..., B) leaf: batch is always the LAST axis in the
    struct-of-arrays layout, everything else replicated."""
    return NamedSharding(mesh, P(*([None] * (ndim - 1) + [axis])))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_env_state(tree, mesh: Mesh, axis: str = ENV_AXIS):
    """Place an EnvState / TimeStep / any (…, B)-leaf pytree on the mesh,
    sharded along the trailing batch axis."""
    return jax.device_put(
        tree,
        jax.tree.map(lambda x: batched_sharding(mesh, np.ndim(x), axis), tree),
    )


def replicate(tree, mesh: Mesh):
    """Place a pytree (e.g. learner params) replicated on every device."""
    return jax.device_put(tree, jax.tree.map(lambda _: replicated(mesh), tree))


_SHARDED_ROLLOUT_CACHE = {}


def sharded_fused_rollout(state, action, num_steps: int, params, spec,
                          mesh: Mesh, *, seed: int = 0, env_ids=None,
                          axis: str = ENV_AXIS, interpret: bool = False):
    """Multi-device version of `ops.pallas_rollout.fused_rollout`: the env
    batch is sharded over the mesh and every device runs the whole-rollout
    Pallas kernel on its local shard — environments never communicate, so
    the rollout scales with zero collectives (SURVEY.md §2.3).  The batch
    must divide by the mesh size; `interpret=True` runs the kernel in the
    Pallas interpreter (tests on the CPU mesh).

    Reset wind kicks are a counter hash of (GLOBAL env id, episode, seed);
    every shard uses the same seed and its envs' global ids, so the result
    is bit-identical to the unsharded kernel on any mesh shape — including
    with `initial_random_force != 0` (the envs/base.py:16-19
    layout-independence contract; asserted by
    tests/test_pallas_rollout.py::test_sharded_random_reset_layout_independent).

    env_ids: (B,) GLOBAL env ids (default arange(B)).

    The shard_map is wrapped in an outer jit cached per (mesh, task,
    num_steps), so repeated calls dispatch one compiled program.

    Returns the same (EnvState, totals) as fused_rollout.
    """
    from gym_copter_tpu.ops import pallas_rollout as pr

    b = state.dyn.x.shape[-1]
    n_dev = mesh.devices.size
    if b % n_dev != 0:
        raise ValueError(f'batch {b} must be a multiple of mesh size {n_dev}')
    if env_ids is None:
        env_ids = jnp.arange(b, dtype=jnp.int32)

    cache_key = (mesh, num_steps, params, spec, axis, interpret)
    fn = _SHARDED_ROLLOUT_CACHE.get(cache_key)
    if fn is None:
        def spec_of_ndim(ndim):
            return P(*([None] * (ndim - 1) + [axis]))

        in_specs = tuple(spec_of_ndim(np.ndim(a)) for a in (
            state.dyn.x, state.dyn.perturb, state.dyn.status,
            state.dyn.ticks, state.steps, state.prev_shaping,
            state.episode, state.initial_random_x, action)) + (P(axis), P())

        def local(x, perturb, status, ticks, steps, pshape, episode,
                  init_rx, act, ids, seed_arr):
            from gym_copter_tpu.core.dynamics import DynamicsState
            from gym_copter_tpu.envs.base import EnvState as ES
            st = ES(dyn=DynamicsState(x=x, status=status, perturb=perturb,
                                      ticks=ticks),
                    prev_shaping=pshape, steps=steps, episode=episode,
                    initial_random_x=init_rx)
            out, tot = pr.fused_rollout(st, act, num_steps, params, spec,
                                        seed=seed_arr, env_ids=ids,
                                        interpret=interpret)
            return (out.dyn.x, out.dyn.perturb, out.dyn.status,
                    out.dyn.ticks, out.steps, out.prev_shaping, out.episode,
                    out.initial_random_x, tot['reward_sum'],
                    tot['episodes'])

        out_specs = (P(None, axis), P(None, axis), P(axis), P(axis),
                     P(axis), P(axis), P(axis), P(axis), P(axis), P(axis))
        # check_vma off: pallas_call outputs don't carry vma metadata
        fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=in_specs,
                                   out_specs=out_specs, check_vma=False))
        _SHARDED_ROLLOUT_CACHE[cache_key] = fn

    outs = fn(state.dyn.x, state.dyn.perturb, state.dyn.status,
              state.dyn.ticks, state.steps, state.prev_shaping,
              state.episode, state.initial_random_x, action,
              jnp.asarray(env_ids, jnp.int32), jnp.asarray(seed, jnp.int32))
    (x, perturb, status, ticks, steps, pshape, episode, init_rx,
     acc, eps) = outs

    from gym_copter_tpu.core.dynamics import DynamicsState
    from gym_copter_tpu.envs.base import EnvState as ES
    new_state = ES(dyn=DynamicsState(x=x, status=status, perturb=perturb,
                                     ticks=ticks),
                   prev_shaping=pshape, steps=steps, episode=episode,
                   initial_random_x=init_rx)
    return new_state, {'reward_sum': acc, 'episodes': eps}
