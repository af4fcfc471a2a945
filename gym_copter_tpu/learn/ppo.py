"""PPO actor-learner over batched copter environments.

The reference delegated learning to external frameworks (NEAT-Gym, AC-Gym
TD3, nengo — SURVEY.md §2.2 L8); here the learner is part of the framework
and batched: rollout (a T-step `lax.scan` over the batched env), GAE,
and the clipped-surrogate updates all live inside ONE jitted train step.
Under a device mesh the env batch is sharded along `env` and parameters are
replicated; the SPMD partitioner inserts the gradient all-reduce
automatically — no hand-written collectives.

Layout: everything is features-first — obs (obs_dim, N), hidden (h, N),
actions (A, N) — so the policy matmuls are (h, in) @ (in, N) with the env
batch as the wide dimension, exactly the layout the env engine produces
(envs/base.py).

Action parameterization: the env clips raw motor values to [0, 1]
(task.py:91) and the useful range around hover is vehicle-dependent (e.g.
~0.0166 for the active DJI Phantom), so the policy acts in a normalized
space: env_action = hover * (1 + a), a ~ N(mu, sigma) — a=0 is hover, the
reachable range is [0, 2*hover].  (The reference's own AltHold task does an
analogous [-1,1] -> [0,1] rescale, attic/gym_copter/envs/althold.py:36-55.)
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from gym_copter_tpu.control.heuristics import hover_motor_value
from gym_copter_tpu.core.types import EnvParams
from gym_copter_tpu.envs import base
from gym_copter_tpu.envs.base import EnvState, TaskSpec


class PPOConfig(NamedTuple):
    rollout_steps: int = 128
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    epochs: int = 4
    # None = auto: resolved to scaled_minibatches(num_envs) where the env
    # batch is known (train(), make_train_step), holding the tuned 32k
    # minibatch SIZE fixed as the batch grows.  Before round 5 the default
    # was a fixed count of 4, so train(num_envs=4096) out of the box got
    # the 131k-transition minibatches that collapsed the round-3 Lander3D
    # runs.  Pass an int to pin the count explicitly.
    minibatches: int | None = None
    value_coef: float = 0.5
    entropy_coef: float = 1e-3
    max_grad_norm: float = 0.5
    hidden: int = 64
    init_log_std: float = -1.0
    obs_scale: float = 10.0  # bounds/altitude are ~10 m (task.py:36-38)
    # constant added to the actor-mean output: 0.0 starts the policy AT
    # hover (task pre-solved — useful for control experiments); -1.0 starts
    # with motors off, so hovering must actually be learned.
    init_action_bias: float = -1.0
    # stability knobs: PPO-style value clipping (0 disables), a clamp on
    # the learnable exploration log-std (stops late-training std collapse /
    # blow-up, the usual cause of post-peak curve collapse), and linear LR
    # annealing to anneal_lr_floor * learning_rate over the whole run
    # (enabled by train() when the update count is known).
    value_clip: float = 0.2
    log_std_min: float = -4.0
    log_std_max: float = 0.5
    anneal_lr: bool = True
    anneal_lr_floor: float = 0.05
    # minibatch shuffle granularity: the T*B rollout buffer is shuffled by
    # permuting contiguous BLOCKS of this many transitions rather than
    # single elements.  A block is `shuffle_block` consecutive envs at one
    # timestep (flat index = t*B + b), i.e. independent environments.  A
    # block gather moves 512-byte+ contiguous runs where an element-wise
    # permutation gathers 4-byte scalars.
    #
    # None = auto (round 5): 128 when a 128-env block is <= 1/32 of the
    # env batch (num_envs >= 4096), element-wise (1) below.  Evidence:
    # at 4096/8192 envs block holds 334-337 final-window on Lander3D
    # (docs/lander3d_curve_4096*.json, _8192.json) and at 1024 on Hover3D
    # block wins at full length (999/999/971 vs element 264/992/801,
    # docs/hover3d_shuffle_ablation_full.json) — but on LANDER3D at 1024
    # envs, where one block is 1/8 of the batch, block shuffling
    # destabilizes long runs (215.7/323.4/233.8 final-window at 3500
    # updates vs 325.1/314.5/325.7 for element on the same seeds/metric,
    # docs/lander3d_curve_1024_block_vs_element.json).  Within-minibatch
    # correlation grows with block/num_envs; the auto rule only uses
    # blocks where they are a validated-small fraction.  Counter-signal,
    # recorded honestly: on Hover3D@1024 full length the ordering is
    # reversed (block 999/999/971 vs element 264/992/801) with heavy
    # seed-variance overlap — but the costs are asymmetric: Hover3D
    # solves far beyond its targets under either granularity, while
    # Lander3D@1024 under block MISSES its 300 target on 2/3 seeds, so
    # element is the safe small-batch default.  Explicit ints are
    # honored (1 = exact element-wise semantics).  If T*B %
    # shuffle_block != 0 the trainer falls back to 1 automatically.
    shuffle_block: int | None = None
    # trust-region guard: the first MINIBATCH whose approx-KL (measured on
    # the current params, before its own update) exceeds this is skipped,
    # along with everything after it in the update (gradients computed but
    # masked to zero — scan-friendly early stopping).  0 disables.  This is
    # the main defense against the slow late-training policy drift that LR
    # annealing alone leaves: even at small LR, Adam renormalizes gradient
    # scale, so thousands of tail updates can still walk the policy off a
    # good optimum.  (Round-2 used an epoch-level check, which let up to
    # `minibatches` oversized steps through before tripping.)
    target_kl: float = 0.0
    # matmul dtype for the policy/critic MLPs: None = f32 operands at JAX's
    # default matmul precision, which on an NVIDIA GPU may run the dot in
    # TF32 (a 10-bit mantissa) — wrap the step in
    # `jax.default_matmul_precision('highest')` for full f32; 'bfloat16'
    # runs the dots with bf16 operands and f32 accumulation
    # (weights/optimizer/activations-between-layers stay f32).
    matmul_dtype: str | None = None


def scaled_minibatches(num_envs: int, base_envs: int = 1024,
                       base_minibatches: int = 4) -> int:
    """Batch-size scaling rule: hold the MINIBATCH size fixed as the env
    batch grows.

    The validated Lander3D recipe (docs/lander3d_curve.json) was tuned at
    1024 envs x 128 rollout steps / 4 minibatches = 32,768 transitions per
    gradient step.  Re-running it at 4096 envs with minibatches=4 keeps the
    update count but quadruples the minibatch (131k), which quarters both
    the gradient noise and the optimizer steps taken per environment step —
    and the policy never leaves the hover plateau (round-3 r3b collapse,
    final-window 186.6; round-4 rerun with the fixed recipe, 77.5).
    Scaling `minibatches` with the env batch (16 at 4096) restores the
    exact per-gradient-step dynamics of the tuned recipe; each update then
    simply performs 4x more of the same steps on 4x more data.  This is the
    default: PPOConfig.minibatches=None resolves through this rule wherever
    the env-batch size is known.  Validated: 4096 envs / minibatches=16
    holds 335 +/- 1 final-window across 3 seeds
    (docs/lander3d_curve_4096.json) where minibatches=4 collapsed; 8192 /
    32 holds the same (docs/lander3d_curve_8192.json).

    The rule holds the minibatch size at exactly 32,768 only when num_envs
    is a multiple of base_envs / base_minibatches = 256 (otherwise the
    floor-division makes minibatches slightly coarse and the size drifts
    above 32k by up to ~12%); non-multiples also generally leave
    T*B % minibatches != 0, whose remainder transitions the updater drops —
    resolve_minibatches warns on both."""
    return max(1, (num_envs * base_minibatches) // base_envs)


def resolve_minibatches(cfg: PPOConfig, num_envs: int) -> PPOConfig:
    """Resolve cfg.minibatches=None to the batch-scaling rule (and
    cfg.shuffle_block=None to the block-fraction rule — see the
    PPOConfig.shuffle_block comment), sanity-checking explicit values
    (see scaled_minibatches).  Idempotent."""
    import sys

    if cfg.shuffle_block is None:
        cfg = cfg._replace(
            shuffle_block=128 if num_envs >= 4096 else 1)
    mbs = cfg.minibatches
    if mbs is None:
        # scaling UP from the tuned 1024-env recipe holds the 32k minibatch
        # SIZE fixed (scaled_minibatches); BELOW 1024 envs that size is
        # unreachable, so hold the tuned COUNT of 4 instead — dev/test-scale
        # runs keep the pre-r5 default behavior (more, smaller minibatches)
        # rather than collapsing to a single gradient step per epoch
        mbs = scaled_minibatches(num_envs) if num_envs >= 1024 else 4
        if num_envs >= 1024 and num_envs % 256 != 0:
            print(f'WARNING: scaled_minibatches holds the tuned 32k '
                  f'minibatch size exactly only for num_envs % 256 == 0; '
                  f'num_envs={num_envs} gives minibatch size '
                  f'{num_envs * cfg.rollout_steps // mbs}', file=sys.stderr)
    else:
        # explicit override: warn on the round-3 collapse recipe
        mb_size = num_envs * cfg.rollout_steps // mbs
        if mb_size >= int(1.5 * 32768):
            print(f'WARNING: minibatch size {mb_size} >> the tuned 32768; '
                  f'large minibatches quartered learning at 4096 envs '
                  f'(docs/lander3d_curve_4096.json) — consider '
                  f'cfg.minibatches=None (auto) or '
                  f'ppo.scaled_minibatches({num_envs}) '
                  f'= {scaled_minibatches(num_envs)}', file=sys.stderr)
    n = num_envs * cfg.rollout_steps
    if n % mbs != 0:
        print(f'WARNING: {n} rollout transitions do not divide into '
              f'{mbs} minibatches; the trailing {n % mbs} transitions '
              f'of each epoch are dropped', file=sys.stderr)
    return cfg._replace(minibatches=mbs)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    env_state: EnvState
    obs: jnp.ndarray        # (obs_dim, B)
    key: jnp.ndarray
    update_idx: jnp.ndarray


def init_mlp_params(key, sizes, dtype=jnp.float32):
    """Orthogonally-initialized MLP; weights (out, in) for features-first."""
    params = []
    keys = jax.random.split(key, len(sizes) - 1)
    for k, (n_in, n_out) in zip(keys, zip(sizes[:-1], sizes[1:])):
        w = jax.nn.initializers.orthogonal(jnp.sqrt(2.0))(
            k, (n_out, n_in), dtype)
        params.append({'w': w, 'b': jnp.zeros((n_out,), dtype)})
    return params


def mlp_apply(params, x, matmul_dtype=None):
    """x: (in, N) -> (out, N); tanh hidden activations.

    matmul_dtype='bfloat16' casts weights and activations to bf16 for the
    matmuls with f32 accumulation (preferred_element_type); biases,
    activations between layers, and everything outside the dots stay f32.
    None keeps f32 operands at the default matmul precision (TF32 on an
    NVIDIA GPU unless a higher precision is requested).
    """
    for i, layer in enumerate(params):
        if matmul_dtype is not None:
            dt = jnp.dtype(matmul_dtype)
            y = jax.lax.dot_general(
                layer['w'].astype(dt), x.astype(dt),
                (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            x = y + layer['b'][:, None]
        else:
            x = layer['w'] @ x + layer['b'][:, None]
        if i < len(params) - 1:
            x = jnp.tanh(x)
    return x


def init_params(key, obs_size, action_size, cfg: PPOConfig, dtype=jnp.float32):
    k1, k2 = jax.random.split(key)
    actor = init_mlp_params(k1, (obs_size, cfg.hidden, cfg.hidden, action_size),
                            dtype)
    # small final actor layer for near-zero initial means
    actor[-1]['w'] = actor[-1]['w'] * 0.01
    critic = init_mlp_params(k2, (obs_size, cfg.hidden, cfg.hidden, 1), dtype)
    return {
        'actor': actor,
        'critic': critic,
        'log_std': jnp.full((action_size,), cfg.init_log_std, dtype),
    }


def _clipped_log_std(params, cfg: PPOConfig):
    return jnp.clip(params['log_std'], cfg.log_std_min, cfg.log_std_max)


def _policy(params, obs, cfg: PPOConfig):
    """Returns (mean (A,N), log_std (A,1), value (N,))."""
    x = obs / cfg.obs_scale
    mean = mlp_apply(params['actor'], x, cfg.matmul_dtype) \
        + cfg.init_action_bias
    value = mlp_apply(params['critic'], x, cfg.matmul_dtype)[0]
    return mean, _clipped_log_std(params, cfg)[:, None], value


def _log_prob(mean, log_std, action):
    """Diagonal-Gaussian log density summed over the action axis (axis 0)."""
    z = (action - mean) * jnp.exp(-log_std)
    return jnp.sum(-0.5 * z * z - log_std - 0.5 * jnp.log(2 * jnp.pi), axis=0)


class Transition(NamedTuple):
    obs: jnp.ndarray       # (obs_dim, B)
    action: jnp.ndarray    # (A, B) raw normalized action
    log_prob: jnp.ndarray  # (B,)
    value: jnp.ndarray     # (B,)
    reward: jnp.ndarray    # (B,)
    done: jnp.ndarray      # (B,)


def make_train_step(env_params: EnvParams, spec: TaskSpec, cfg: PPOConfig,
                    base_key, env_ids, optimizer=None, mesh=None):
    """Builds the jitted PPO train step closed over static config.

    The exploration rollout is an XLA `lax.scan`; under a `mesh` the
    automatic SPMD partitioner shards it along the env axis."""
    cfg = resolve_minibatches(cfg, int(env_ids.shape[0]))
    hover = hover_motor_value(env_params)
    if optimizer is None:
        optimizer = optax.chain(
            optax.clip_by_global_norm(cfg.max_grad_norm),
            optax.adam(cfg.learning_rate),
        )

    def scan_rollout(params, env_state, obs, key):
        def step_fn(carry, _):
            env_state, obs, key = carry
            key, sub = jax.random.split(key)
            mean, log_std, value = _policy(params, obs, cfg)
            noise = jax.random.normal(sub, mean.shape, mean.dtype)
            action = mean + jnp.exp(log_std) * noise
            log_prob = _log_prob(mean, log_std, action)
            env_action = hover * (1.0 + action)
            env_state, ts = base.step(env_state, env_action, base_key,
                                      env_ids, env_params, spec)
            tr = Transition(obs=obs, action=action, log_prob=log_prob,
                            value=value, reward=ts.reward, done=ts.done)
            return (env_state, ts.obs, key), tr

        (env_state, obs, key), traj = jax.lax.scan(
            step_fn, (env_state, obs, key), None, length=cfg.rollout_steps)
        return env_state, obs, key, traj

    rollout = scan_rollout

    def compute_gae(traj: Transition, last_value):
        def scan_fn(gae, tr):
            nonterminal = 1.0 - tr[3]
            delta = tr[0] + cfg.gamma * tr[1] * nonterminal - tr[2]
            gae = delta + cfg.gamma * cfg.gae_lambda * nonterminal * gae
            return gae, gae

        next_values = jnp.concatenate(
            [traj.value[1:], last_value[None]], axis=0)
        _, advantages = jax.lax.scan(
            scan_fn, jnp.zeros_like(last_value),
            (traj.reward, next_values, traj.value, traj.done.astype(jnp.float32)),
            reverse=True)
        return advantages, advantages + traj.value

    def loss_fn(params, obs, action, old_log_prob, old_value, advantage,
                target):
        mean, log_std, value = _policy(params, obs, cfg)
        log_prob = _log_prob(mean, log_std, action)
        ratio = jnp.exp(log_prob - old_log_prob)
        adv = (advantage - advantage.mean()) / (advantage.std() + 1e-8)
        pg1 = ratio * adv
        pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -jnp.mean(jnp.minimum(pg1, pg2))
        if cfg.value_clip > 0:
            # PPO value clipping: bound how far the critic may move from
            # its rollout-time prediction per update, pessimistic max
            v_clipped = old_value + jnp.clip(value - old_value,
                                             -cfg.value_clip, cfg.value_clip)
            v_loss = 0.5 * jnp.mean(jnp.maximum((value - target) ** 2,
                                                (v_clipped - target) ** 2))
        else:
            v_loss = 0.5 * jnp.mean((value - target) ** 2)
        entropy = jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e))
        loss = pg_loss + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
        # approx_kl: E[ratio - 1 - log(ratio)] (the low-variance k3
        # estimator) — drives the target_kl trust-region guard
        approx_kl = jnp.mean((ratio - 1.0) - (log_prob - old_log_prob))
        return loss, (pg_loss, v_loss, entropy, approx_kl)

    def update_epoch(carry, _):
        params, opt_state, key, stop, flat = carry
        n = flat[0].shape[-1]
        key, sub = jax.random.split(key)
        # block shuffle: permute contiguous blocks once per epoch, then take
        # contiguous minibatch slices — identical to gathering with a
        # blockwise permutation, at HBM bandwidth instead of scalar-gather
        # speed (see PPOConfig.shuffle_block)
        block = cfg.shuffle_block if n % cfg.shuffle_block == 0 else 1
        nblocks = n // block
        perm = jax.random.permutation(sub, nblocks)

        def shuffle(x):
            xb = x.reshape(*x.shape[:-1], nblocks, block)
            return jnp.take(xb, perm, axis=-2).reshape(*x.shape)

        obs, action, old_lp, old_v, adv, tgt = (
            jax.tree.map(shuffle, flat))
        mb = n // cfg.minibatches

        def update_minibatch(carry, i):
            params, opt_state, stop = carry

            def slc(x):
                return jax.lax.dynamic_slice_in_dim(x, i * mb, mb, axis=-1)

            grads, aux = jax.grad(loss_fn, has_aux=True)(
                params, slc(obs), slc(action), slc(old_lp),
                slc(old_v), slc(adv), slc(tgt))
            updates, opt_state0 = optimizer.update(grads, opt_state, params)
            if cfg.target_kl > 0:
                # per-minibatch early stop: the approx-KL is computed on the
                # *current* params, so the first minibatch whose KL exceeds
                # the target is itself skipped (spinning-up semantics) and
                # everything after it becomes a no-op — an epoch-level check
                # would let up to `minibatches` oversized steps through
                # before tripping (the round-2 failure mode).  scan needs
                # static structure, so gradients are computed then discarded.
                stop = stop | (aux[3] > cfg.target_kl)
                updates = jax.tree.map(
                    lambda u: jnp.where(stop, jnp.zeros_like(u), u), updates)
                opt_state0 = jax.tree.map(
                    lambda new, old: jnp.where(stop, old, new),
                    opt_state0, opt_state)
            params = optax.apply_updates(params, updates)
            return (params, opt_state0, stop), aux

        (params, opt_state, stop), aux = jax.lax.scan(
            update_minibatch, (params, opt_state, stop),
            jnp.arange(cfg.minibatches))
        return (params, opt_state, key, stop, flat), aux

    def train_step(ts: TrainState):
        env_state, obs, key, traj = rollout(ts.params, ts.env_state, ts.obs,
                                            ts.key)
        _, _, last_value = _policy(ts.params, obs, cfg)
        adv, target = compute_gae(traj, last_value)

        # flatten (T, …, B) -> (…, T*B), features-first preserved
        def flat2(x):  # (T, B) -> (T*B,)
            return x.reshape(-1)

        def flat3(x):  # (T, D, B) -> (D, T*B)
            return jnp.moveaxis(x, 1, 0).reshape(x.shape[1], -1)

        flat = (flat3(traj.obs), flat3(traj.action), flat2(traj.log_prob),
                flat2(traj.value), flat2(adv), flat2(target))

        stop0 = jnp.zeros((), bool)
        (params, opt_state, key, _, _), aux = jax.lax.scan(
            update_epoch, (ts.params, ts.opt_state, key, stop0, flat), None,
            length=cfg.epochs)

        metrics = {
            'reward_per_step': traj.reward.mean(),
            'episode_return_proxy': traj.reward.sum(0).mean(),
            'done_rate': traj.done.mean(),
            'pg_loss': aux[0].mean(),
            'v_loss': aux[1].mean(),
            'entropy': aux[2].mean(),
            'approx_kl': aux[3].mean(),
        }
        new_ts = TrainState(params=params, opt_state=opt_state,
                            env_state=env_state, obs=obs, key=key,
                            update_idx=ts.update_idx + 1)
        return new_ts, metrics

    return train_step, optimizer


def init_train_state(key, env_params: EnvParams, spec: TaskSpec,
                     cfg: PPOConfig, num_envs: int, optimizer,
                     env_id_offset: int = 0, dtype=jnp.float32) -> TrainState:
    kp, kr = jax.random.split(key)
    params = init_params(kp, spec.obs_size, spec.action_size, cfg, dtype)
    env_ids = env_id_offset + jnp.arange(num_envs, dtype=jnp.int32)
    env_state, obs = base.reset(key, env_ids, jnp.zeros(num_envs, jnp.int32),
                                env_params, spec, dtype=dtype)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      env_state=env_state, obs=obs, key=kr,
                      update_idx=jnp.zeros((), jnp.int32))


# eval batch used by train()'s learning-curve metric; tests that re-evaluate
# a returned policy must use the same batch to reproduce the curve value
EVAL_NUM_ENVS = 1024


def make_eval_fn(env_params: EnvParams, spec: TaskSpec, cfg: PPOConfig,
                 num_envs: int = EVAL_NUM_ENVS, num_steps: int = 999,
                 seed: int = 1000):
    """Deterministic-policy evaluation: fresh episodes, mean actions, return
    per episode averaged over the batch — the learning-curve metric
    (crashing early scores ~140 on Hover3D, perfect hovering ~999)."""
    hover = hover_motor_value(env_params)
    base_key = jax.random.PRNGKey(seed)
    env_ids = jnp.arange(num_envs, dtype=jnp.int32)

    @jax.jit
    def evaluate(params):
        env_state, obs = base.reset(base_key, env_ids,
                                    jnp.zeros(num_envs, jnp.int32),
                                    env_params, spec)

        def step_fn(carry, _):
            env_state, obs, total, done_seen = carry
            mean, _, _ = _policy(params, obs, cfg)
            env_action = hover * (1.0 + mean)
            env_state, ts = base.step(env_state, env_action, base_key,
                                      env_ids, env_params, spec)
            total = total + jnp.where(done_seen, 0.0, ts.reward)
            return (env_state, ts.obs, total, done_seen | ts.done), None

        init = (env_state, obs, jnp.zeros(num_envs, jnp.float32),
                jnp.zeros(num_envs, bool))
        (_, _, total, done_seen), _ = jax.lax.scan(step_fn, init, None,
                                                   length=num_steps)
        return total.mean(), total

    return evaluate


def train(env_name: str = 'Hover3D-v0', num_envs: int = 1024,
          num_updates: int = 200, seed: int = 0,
          cfg: PPOConfig = PPOConfig(), env_params: EnvParams = None,
          mesh=None, log_every: int = 10, callback=None,
          keep_best: bool = False):
    """Host-side training loop (convenience wrapper; the real work is the
    jitted train_step).  If `mesh` is given, env state is sharded along the
    batch axis and params replicated before stepping."""
    from gym_copter_tpu.envs import tasks as task_registry
    from gym_copter_tpu.envs.registry import default_params

    spec = task_registry.ALL_TASKS[env_name]
    if env_params is None:
        # named presets (Mars vehicle/world, attic simple-lander vehicle)
        # resolve exactly as registry.make() does — without this,
        # train('Hover3DMars-v0') would silently fly Earth params
        preset = task_registry.PRESET_PARAMS.get(env_name)
        env_params = preset() if preset is not None else default_params()

    # resolve minibatches=None through the batch-scaling rule (and warn on
    # explicit collapse-prone overrides) — silently quadrupling the
    # minibatch by raising num_envs alone was the round-3 collapse mode
    cfg = resolve_minibatches(cfg, num_envs)

    key = jax.random.PRNGKey(seed)
    base_key = jax.random.PRNGKey(seed + 1)
    env_ids = jnp.arange(num_envs, dtype=jnp.int32)
    optimizer = None
    if cfg.anneal_lr:
        # linear LR decay over the whole run (counted in optimizer steps:
        # epochs * minibatches per update) — the single biggest stabilizer
        # against late-training policy collapse
        schedule = optax.linear_schedule(
            init_value=cfg.learning_rate,
            end_value=cfg.learning_rate * cfg.anneal_lr_floor,
            transition_steps=num_updates * cfg.epochs * cfg.minibatches)
        optimizer = optax.chain(
            optax.clip_by_global_norm(cfg.max_grad_norm),
            optax.adam(schedule),
        )
    train_step, optimizer = make_train_step(env_params, spec, cfg, base_key,
                                            env_ids, mesh=mesh,
                                            optimizer=optimizer)
    ts = init_train_state(key, env_params, spec, cfg, num_envs, optimizer)

    if mesh is not None:
        from gym_copter_tpu.parallel import sharding as sh
        ts = TrainState(
            params=sh.replicate(ts.params, mesh),
            opt_state=sh.replicate(ts.opt_state, mesh),
            env_state=sh.shard_env_state(ts.env_state, mesh),
            obs=sh.shard_env_state(ts.obs, mesh),
            key=ts.key, update_idx=ts.update_idx)

    step = jax.jit(train_step, donate_argnums=0)
    evaluate = make_eval_fn(env_params, spec, cfg, num_envs=EVAL_NUM_ENVS)
    history = []
    best_eval, best_params = -float('inf'), None
    for i in range(num_updates):
        ts, metrics = step(ts)
        if i % log_every == 0 or i == num_updates - 1:
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics['eval_return'] = float(evaluate(ts.params)[0])
            if keep_best and metrics['eval_return'] > best_eval:
                best_eval = metrics['eval_return']
                best_params = jax.tree.map(
                    lambda x: jnp.array(x, copy=True), ts.params)
            history.append((i, metrics))
            if callback:
                callback(i, metrics)
            else:
                print(f'update {i:4d}  eval_return {metrics["eval_return"]:8.2f}  '
                      f'reward/step {metrics["reward_per_step"]:7.4f}  '
                      f'done {metrics["done_rate"]:.3f}')
    if keep_best and best_params is not None:
        # model selection across eval points: the returned policy is the
        # best evaluated one, not whatever the last gradient step produced
        # (standard checkpoint-selection; the curve in `history` still
        # records the raw trajectory so instability remains visible)
        ts = ts._replace(params=best_params)
    return ts, history
