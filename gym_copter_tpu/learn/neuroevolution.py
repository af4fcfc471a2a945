"""Batched NEAT-style neuroevolution.

The reference evolves Lander2D controllers with ES-HyperNEAT via the
external NEAT-Gym runner (attic/neat/README.md:10-23), configured with
pop_size=96, episode_reps=10, fitness_threshold=300
(attic/neat/config/lander2d:10-20) and per-connection weight mutation
(power 0.5, rate 0.8, replace 0.1, attic/neat/config/lander2d:52-55),
evaluated with neat-python's *process*-parallel fitness evaluator
(attic/neat/README.md:23-26).

This module is the batched re-design of that capability, not a port of
neat-python:

* **Population-in-one-jit evaluation.**  NEAT's process pool becomes a
  single XLA program: the whole population x episode_reps batch
  (pop*reps lockstep environments) steps inside one `lax.scan`, with the
  per-genome recurrent network applied as population-stacked einsums.
  One device dispatch per generation instead of one process per
  genome.
* **Static-shape topology search.**  NEAT grows nodes/connections
  dynamically — hostile to XLA's compile-once model.  Here every genome
  carries a fixed *maximum* topology (direct input->output connections
  plus one recurrent hidden block, `feed_forward=False` per the reference
  config) and a {0,1} mask per connection; structural mutation toggles
  mask bits.  Evolution starts from NEAT's `initial_connection =
  full_direct` state (all direct connections enabled, hidden block
  disabled, attic/neat/config/lander2d:46) and complexifies by enabling
  hidden connections — the same minimal-to-complex search, with shapes
  XLA can compile once.
* **Genetics in-jit too.**  Elitism, tournament selection, uniform
  per-connection crossover (weight and enable-bit travel together, as in
  NEAT's gene-level crossover), and weight/structure mutation are one
  jitted `evolve` step on the population pytree.  Speciation is replaced
  by tournament selection + elitism (documented deviation: NEAT's
  explicit fitness sharing assumes positive fitness; Lander returns start
  near -200).

Fitness matches the reference criterion: mean return over `episode_reps`
fresh episodes (fresh wind kicks each generation), terminating when the
population max reaches `fitness_threshold` (fitness_criterion = max,
attic/neat/config/lander2d:11-12).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from gym_copter_tpu.control.heuristics import hover_motor_value
from gym_copter_tpu.core.types import EnvParams
from gym_copter_tpu.envs import base, tasks


class Genome(NamedTuple):
    """Population-stacked genomes (leading axis = pop).

    Connection arrays come in (weight, mask) pairs; a mask bit is NEAT's
    per-gene `enabled` flag.  `w_dir` is the direct input->output block
    (the `full_direct` initial topology); `w_in`/`w_rec`/`w_out` form the
    recurrent hidden block that structural mutation switches on.
    """

    w_dir: jnp.ndarray   # (P, A, O)
    m_dir: jnp.ndarray
    w_in: jnp.ndarray    # (P, H, O)
    m_in: jnp.ndarray
    w_rec: jnp.ndarray   # (P, H, H)
    m_rec: jnp.ndarray
    w_out: jnp.ndarray   # (P, A, H)
    m_out: jnp.ndarray
    b_h: jnp.ndarray     # (P, H)
    b_out: jnp.ndarray   # (P, A)


_PAIRS = (('w_dir', 'm_dir'), ('w_in', 'm_in'),
          ('w_rec', 'm_rec'), ('w_out', 'm_out'))
_BIASES = ('b_h', 'b_out')


@dataclasses.dataclass(frozen=True)
class NeatConfig:
    """Defaults mirror attic/neat/config/lander2d (pop 96, reps 10,
    threshold 300; weight mutation :52-55; tanh activation :58)."""

    pop_size: int = 96
    episode_reps: int = 10
    fitness_threshold: float = 300.0
    hidden: int = 16
    n_elite: int = 2
    tournament: int = 3
    crossover_rate: float = 0.75
    weight_mutate_rate: float = 0.8
    weight_mutate_power: float = 0.5
    weight_replace_rate: float = 0.1
    weight_init_stdev: float = 1.0
    weight_clip: float = 8.0          # [ES] max_weight, config/lander2d:39
    conn_enable_per_child: float = 2.0   # expected mask bits enabled/child
    conn_disable_per_child: float = 0.2  # expected mask bits disabled/child
    # action encoding: 'hover' anchors tanh output at the hover motor value
    # (action = hover * (1 + out), same convention as learn/ppo.py); 'direct'
    # feeds the tanh straight to the env like an external NEAT-Gym learner.
    action_anchor: str = 'hover'
    max_steps: int = 999
    # champion-selection robustness (round 5): per generation the top-k
    # genomes by train fitness are re-scored on a FIXED holdout of
    # `holdout_reps` episodes, and evolution continues past the train
    # threshold until the best holdout score clears threshold +
    # holdout_margin (or max_generations).  Rationale: train fitness is a
    # max over pop x fresh wind kicks — selection-biased by luck — and the
    # round-4 champions picked from a 10-episode holdout scored 262-294 on
    # 100 fresh episodes against the configs' 300 threshold.  The margin
    # covers the remaining winner's-curse bias of argmax-over-generations
    # on a holdout mean with se ~ episode_std/sqrt(holdout_reps).
    topk: int = 4
    holdout_reps: int = 32
    holdout_margin: float = 10.0


def network_step(genome: Genome, obs_pr, h_pr):
    """One tick of every genome's recurrent net, population-stacked.

    obs_pr: (O, P, R) features-first observations, h_pr: (H, P, R) hidden
    state.  Returns (new hidden, tanh outputs (A, P, R)).  Disabled
    connections (mask 0) contribute exactly nothing, so a genome's
    phenotype is its enabled subgraph — NEAT semantics with static shapes.
    """
    h_pr = jnp.tanh(
        jnp.einsum('pho,opr->hpr', genome.w_in * genome.m_in, obs_pr)
        + jnp.einsum('phg,gpr->hpr', genome.w_rec * genome.m_rec, h_pr)
        + genome.b_h.T[:, :, None])
    out = jnp.tanh(
        jnp.einsum('pah,hpr->apr', genome.w_out * genome.m_out, h_pr)
        + jnp.einsum('pao,opr->apr', genome.w_dir * genome.m_dir, obs_pr)
        + genome.b_out.T[:, :, None])
    return h_pr, out


def init_population(key, obs_size: int, action_size: int,
                    cfg: NeatConfig) -> Genome:
    """`initial_connection = full_direct`: every input wired to every
    output (mask 1), hidden block present but disabled (mask 0) — the
    minimal topology NEAT starts from and complexifies."""
    P, H, O, A = cfg.pop_size, cfg.hidden, obs_size, action_size
    ks = jax.random.split(key, 6)
    std = cfg.weight_init_stdev
    return Genome(
        w_dir=std * jax.random.normal(ks[0], (P, A, O)),
        m_dir=jnp.ones((P, A, O)),
        w_in=std * jax.random.normal(ks[1], (P, H, O)),
        m_in=jnp.zeros((P, H, O)),
        w_rec=std * jax.random.normal(ks[2], (P, H, H)),
        m_rec=jnp.zeros((P, H, H)),
        w_out=std * jax.random.normal(ks[3], (P, A, H)),
        m_out=jnp.zeros((P, A, H)),
        b_h=std * jax.random.normal(ks[4], (P, H)),
        b_out=std * jax.random.normal(ks[5], (P, A)),
    )


def _resolve(env_name: str, env_params: Optional[EnvParams]):
    spec = tasks.ALL_TASKS[env_name]
    if env_params is None:
        if env_name in tasks.PRESET_PARAMS:
            env_params = tasks.PRESET_PARAMS[env_name]()
        else:
            from gym_copter_tpu.envs.registry import default_params
            env_params = default_params()
    return spec, env_params


def make_fitness_fn(env_name: str, cfg: NeatConfig,
                    env_params: Optional[EnvParams] = None,
                    reps: Optional[int] = None, seed: int = 1000,
                    mesh=None, return_episodes: bool = False):
    """fitness(genome, episode) -> (P,) mean first-episode return over
    `reps` fresh environments per genome — the whole population evaluated
    as ONE jitted scan over pop*reps lockstep envs.  `episode` indexes the
    reset randomness so each generation sees fresh wind kicks (NEAT-Gym
    episodes are freshly seeded too).

    With `mesh` (a 1-D env-axis device mesh, parallel/sharding.make_mesh),
    the env batch shards across devices (each device evaluates a
    contiguous slice of genomes, zero collectives until the final (P,)
    gather) and the genome replicates.  Requires pop_size % n_devices == 0
    so the (O, B) -> (O, P, R) reshape stays shard-aligned.  Reset
    randomness is keyed by global env id, so sharded fitness equals
    single-device fitness."""
    spec, env_params = _resolve(env_name, env_params)
    P = cfg.pop_size
    R = reps if reps is not None else cfg.episode_reps
    O, A, B = spec.obs_size, spec.action_size, P * R
    hover = (hover_motor_value(env_params) if cfg.action_anchor == 'hover'
             else None)
    base_key = jax.random.PRNGKey(seed)
    env_ids = jnp.arange(B, dtype=jnp.int32)
    if mesh is not None:
        from gym_copter_tpu.parallel import sharding as sh
        if P % mesh.devices.size:
            raise ValueError(f'pop_size {P} not divisible by '
                             f'{mesh.devices.size} devices')
        env_ids = jax.device_put(env_ids, sh.env_sharding(mesh))

    @jax.jit
    def fitness(genome: Genome, episode) -> jnp.ndarray:
        ep = jnp.full((B,), episode, jnp.int32)
        env_state, obs = base.reset(base_key, env_ids, ep, env_params, spec)
        h0 = jnp.zeros((cfg.hidden, P, R))

        def step_fn(carry, _):
            env_state, obs, h, total, done_seen = carry
            h, out = network_step(genome, obs.reshape(O, P, R), h)
            act = (hover * (1.0 + out)) if hover is not None else out
            env_state, ts = base.step(env_state, act.reshape(A, B),
                                      base_key, env_ids, env_params, spec)
            total = total + jnp.where(done_seen, 0.0, ts.reward)
            return (env_state, ts.obs, h, total, done_seen | ts.done), None

        init = (env_state, obs, h0, jnp.zeros(B, jnp.float32),
                jnp.zeros(B, bool))
        (_, _, _, total, _), _ = jax.lax.scan(step_fn, init, None,
                                              length=cfg.max_steps)
        per_episode = total.reshape(P, R)
        return per_episode if return_episodes else per_episode.mean(axis=1)

    return fitness


def make_evolve_fn(cfg: NeatConfig):
    """evolve(genome, fitness, key) -> next generation, jitted.

    Elitism (top n_elite copied verbatim), tournament parent selection,
    uniform per-connection crossover with weight+enable travelling
    together (NEAT gene crossover), then weight mutation
    (perturb/replace/clip per attic/neat/config/lander2d:52-55) and
    structural mask mutation (expected `conn_enable_per_child` bits
    switched on, `conn_disable_per_child` off)."""
    P = cfg.pop_size

    def tournament(key, fit):
        idx = jax.random.randint(key, (P, cfg.tournament), 0, P)
        return idx[jnp.arange(P), jnp.argmax(fit[idx], axis=1)]

    @jax.jit
    def evolve(genome: Genome, fit, key) -> Genome:
        k_pa, k_pb, k_cx, k_mut = jax.random.split(key, 4)
        pa, pb = tournament(k_pa, fit), tournament(k_pb, fit)
        use_cx = jax.random.bernoulli(k_cx, cfg.crossover_rate, (P,))

        out = {}
        keys = iter(jax.random.split(k_mut, 7 * len(_PAIRS) + 3 * len(_BIASES)))
        for wname, mname in _PAIRS:
            w, m = getattr(genome, wname), getattr(genome, mname)
            n_conn = w[0].size
            # gene-level crossover: weight and enable-bit from same parent
            pick_b = (jax.random.bernoulli(next(keys), 0.5, w.shape)
                      & use_cx.reshape((P,) + (1,) * (w.ndim - 1)))
            cw = jnp.where(pick_b, w[pb], w[pa])
            cm = jnp.where(pick_b, m[pb], m[pa])
            # weight mutation (on every connection; disabled ones carry
            # their weight silently, as NEAT genes do).  Perturb and replace
            # are mutually exclusive per gene, neat-python semantics: one
            # uniform draw r, r < mutate_rate perturbs, else r <
            # mutate_rate + replace_rate replaces (genome.py mutate logic) —
            # independent application would make the effective statistics
            # drift from the cited config rates.
            r = jax.random.uniform(next(keys), w.shape)
            perturb = r < cfg.weight_mutate_rate
            replace = (~perturb) & (r < cfg.weight_mutate_rate
                                    + cfg.weight_replace_rate)
            cw = cw + jnp.where(perturb, cfg.weight_mutate_power
                                * jax.random.normal(next(keys), w.shape), 0.0)
            cw = jnp.where(replace, cfg.weight_init_stdev
                           * jax.random.normal(next(keys), w.shape), cw)
            cw = jnp.clip(cw, -cfg.weight_clip, cfg.weight_clip)
            # structural mutation on the hidden block's masks; the direct
            # block stays NEAT's always-present input->output genes
            if mname != 'm_dir':
                k_en, k_dis = next(keys), next(keys)
                enable = jax.random.bernoulli(
                    k_en, cfg.conn_enable_per_child / n_conn, m.shape)
                disable = jax.random.bernoulli(
                    k_dis, cfg.conn_disable_per_child / n_conn, m.shape)
                cm = jnp.clip(cm + enable - disable, 0.0, 1.0)
            out[wname], out[mname] = cw, cm
        for bname in _BIASES:
            b = getattr(genome, bname)
            cb = jnp.where(jax.random.bernoulli(
                next(keys), 0.5, b.shape) & use_cx[:, None], b[pb], b[pa])
            cb = cb + jnp.where(
                jax.random.bernoulli(next(keys), cfg.weight_mutate_rate,
                                     b.shape),
                cfg.weight_mutate_power * jax.random.normal(next(keys),
                                                            b.shape), 0.0)
            out[bname] = jnp.clip(cb, -cfg.weight_clip, cfg.weight_clip)

        child = Genome(**out)
        # elitism: the n_elite fittest survive unchanged in slots 0..E-1
        elite = jnp.argsort(-fit)[:cfg.n_elite]
        slot = jnp.arange(P)
        src = jnp.where(slot < cfg.n_elite, elite[jnp.minimum(slot,
                        cfg.n_elite - 1)], slot)
        keep = slot < cfg.n_elite

        def pick(c, g):
            mask = keep.reshape((P,) + (1,) * (g.ndim - 1))
            return jnp.where(mask, g[src], c)

        return jax.tree.map(pick, child, genome)

    return evolve


def take_genome(genome: Genome, i) -> Genome:
    """Extract genome i, keeping a pop axis of 1 (so network_step and the
    fitness fn work unchanged with P=1)."""
    return jax.tree.map(lambda g: g[i][None], genome)


def take_genomes(genome: Genome, idx) -> Genome:
    """Extract genomes idx (k,) as a population of k."""
    return jax.tree.map(lambda g: g[idx], genome)


def evolve_population(env_name: str = 'Lander2D-v0',
                      cfg: NeatConfig = NeatConfig(),
                      env_params: Optional[EnvParams] = None,
                      max_generations: int = 500, seed: int = 0,
                      eval_seed: int = 1000, log_every: int = 10,
                      callback=None, mesh=None):
    """The NEAT-Gym `neat-evolve.py` equivalent: evolve until the
    population's best mean-over-reps return reaches fitness_threshold
    (fitness_criterion = max) or max_generations.

    Returns (champion Genome (pop axis 1), history list of per-generation
    dicts, final population).  One device dispatch per generation for
    fitness + one for the top-k holdout + one for evolution.

    Champion selection (round 5; VERDICT r4 weak #3): each generation's
    top-k genomes by train fitness are re-scored on a FIXED holdout set
    (seed eval_seed+1, `cfg.holdout_reps` episodes) and the champion is
    the best held-out scorer across all generations.  Train fitness is a
    max over pop x 10 fresh wind kicks — selection-biased by luck — so
    the round-4 top-1/10-episode version picked champions that scored
    262-294 on 100 fresh episodes.  Termination: evolution continues past
    NEAT's own train criterion (fitness_criterion = max >= threshold,
    whose first-hit generation is recorded per entry) until the champion's
    holdout clears threshold + holdout_margin, or max_generations."""
    spec, env_params = _resolve(env_name, env_params)
    fitness_fn = make_fitness_fn(env_name, cfg, env_params, seed=eval_seed,
                                 mesh=mesh)
    holdout_fn = make_fitness_fn(
        env_name, dataclasses.replace(cfg, pop_size=cfg.topk), env_params,
        reps=cfg.holdout_reps, seed=eval_seed + 1)
    evolve_fn = make_evolve_fn(cfg)
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    genome = init_population(k0, spec.obs_size, spec.action_size, cfg)

    history, best_ever, champion = [], -jnp.inf, None
    train_threshold_gen = None
    for gen in range(max_generations):
        fit = fitness_fn(genome, jnp.int32(gen))
        best_i = int(jnp.argmax(fit))
        best, mean = float(fit[best_i]), float(fit.mean())
        enabled = float(genome.m_in.mean() + genome.m_rec.mean()
                        + genome.m_out.mean()) / 3.0
        topk_i = jnp.argsort(-fit)[:cfg.topk]
        cands = take_genomes(genome, topk_i)
        ho = holdout_fn(cands, jnp.int32(2 ** 30))
        ho_best_i = int(jnp.argmax(ho))
        holdout = float(ho[ho_best_i])
        rec = {'generation': gen, 'best_fitness': best, 'mean_fitness': mean,
               'holdout_best': holdout, 'hidden_conn_frac': enabled}
        if best >= cfg.fitness_threshold and train_threshold_gen is None:
            train_threshold_gen = gen
            rec['train_threshold_reached'] = True
        history.append(rec)
        if holdout > best_ever:
            best_ever = holdout
            champion = take_genome(cands, ho_best_i)
        if callback is not None:
            callback(rec)
        elif gen % log_every == 0:
            print(f'gen {gen:4d}  best {best:8.1f}  mean {mean:8.1f}  '
                  f'holdout {holdout:8.1f}  hidden-conn {enabled:.3f}',
                  flush=True)
        if (best >= cfg.fitness_threshold
                and best_ever >= cfg.fitness_threshold + cfg.holdout_margin):
            break
        key, k = jax.random.split(key)
        genome = evolve_fn(genome, fit, k)
    return champion, history, genome


def evaluate_champion(champion: Genome, env_name: str, cfg: NeatConfig,
                      env_params: Optional[EnvParams] = None,
                      reps: int = 100, seed: int = 77, episode: int = 10000):
    """Robust post-hoc score: the champion on `reps` fresh episodes (the
    NEAT-Gym `neat-test.py` role).  Returns (mean, per-episode returns of
    shape (reps,)) — the per-episode spread is recoverable."""
    one = dataclasses.replace(cfg, pop_size=1)
    fn = make_fitness_fn(env_name, one, env_params, reps=reps, seed=seed,
                         return_episodes=True)
    per_episode = fn(champion, jnp.int32(episode))[0]
    return float(per_episode.mean()), per_episode
