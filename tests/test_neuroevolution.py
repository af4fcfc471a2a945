"""NEAT-style neuroevolution (learn/neuroevolution.py).

The reference's NEAT capability is an external runner
(attic/neat/README.md:10-23) configured by attic/neat/config/lander2d
(pop 96, episode_reps 10, fitness_threshold 300).  These tests exercise
the batched re-design: population-stacked masked networks, one-jit
fitness evaluation, and the jitted genetic step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from gym_copter_tpu.learn import neuroevolution as ne

CFG = ne.NeatConfig(pop_size=8, episode_reps=2, hidden=4, max_steps=64)


def _pop(key=0, obs=6, act=2, cfg=CFG):
    return ne.init_population(jax.random.PRNGKey(key), obs, act, cfg)


def test_initial_topology_is_full_direct():
    """initial_connection = full_direct (attic/neat/config/lander2d:46):
    direct input->output genes all enabled, hidden block all disabled."""
    g = _pop()
    assert float(g.m_dir.min()) == 1.0
    assert float(g.m_in.max()) == 0.0
    assert float(g.m_rec.max()) == 0.0
    assert float(g.m_out.max()) == 0.0


def test_disabled_connections_contribute_nothing():
    """A genome's phenotype is its enabled subgraph: with the hidden block
    masked off, the output must be exactly the direct path; with w_dir
    also masked, exactly tanh(b_out)."""
    g = _pop()
    obs = jax.random.normal(jax.random.PRNGKey(1), (6, CFG.pop_size, 2))
    h = jnp.ones((CFG.hidden, CFG.pop_size, 2))  # junk hidden state
    _, out = ne.network_step(g, obs, h)
    direct = jnp.tanh(jnp.einsum('pao,opr->apr', g.w_dir, obs)
                      + g.b_out.T[:, :, None])
    assert jnp.allclose(out, direct, atol=1e-6)

    g0 = g._replace(m_dir=jnp.zeros_like(g.m_dir))
    _, out0 = ne.network_step(g0, obs, h)
    assert jnp.allclose(out0, jnp.broadcast_to(
        jnp.tanh(g.b_out.T[:, :, None]), out0.shape), atol=1e-6)


def test_fitness_shape_and_rep_grouping():
    """fitness is (P,) and genome p's fitness is the mean over its own R
    env lanes: with reset randomness off (identical episodes for every
    env), two identical genomes must get identical fitness — a wrong
    obs->genome mapping (e.g. reshape order) would break this."""
    from gym_copter_tpu.envs.registry import default_params
    cfg = dataclasses.replace(CFG, pop_size=4)
    params = default_params()
    params = params._replace(task=params.task._replace(
        initial_random_force=0.0))
    fit_fn = ne.make_fitness_fn('Lander2D-v0', cfg, env_params=params)
    g = _pop(cfg=cfg)
    twin = jax.tree.map(lambda a: a.at[1].set(a[0]), g)
    fit = fit_fn(twin, jnp.int32(0))
    assert fit.shape == (4,)
    assert jnp.allclose(fit[0], fit[1], rtol=1e-5)
    # and distinct genomes must in general differ
    assert not jnp.allclose(fit[1], fit[2], rtol=1e-5)


def test_evolve_preserves_elites_and_binary_masks():
    g = _pop()
    fit = jnp.arange(CFG.pop_size, 0.0, -1.0)  # genome 0 is fittest
    nxt = ne.make_evolve_fn(CFG)(g, fit, jax.random.PRNGKey(3))
    # elite slots carry the fittest genomes unchanged
    for leaf_new, leaf_old in zip(jax.tree.leaves(nxt), jax.tree.leaves(g)):
        assert jnp.array_equal(leaf_new[0], leaf_old[0])
        assert jnp.array_equal(leaf_new[1], leaf_old[1])
    # masks stay binary, weights stay clipped
    for m in (nxt.m_dir, nxt.m_in, nxt.m_rec, nxt.m_out):
        assert jnp.all((m == 0.0) | (m == 1.0))
    for w in (nxt.w_dir, nxt.w_in, nxt.w_rec, nxt.w_out):
        assert float(jnp.abs(w).max()) <= CFG.weight_clip + 1e-6


def test_structural_mutation_complexifies():
    """Evolution must actually grow structure from the minimal topology:
    after a few generations some hidden connections are enabled."""
    g = _pop()
    evolve = ne.make_evolve_fn(CFG)
    fit = jnp.zeros(CFG.pop_size)
    for i in range(10):
        g = evolve(g, fit, jax.random.PRNGKey(100 + i))
    grown = (float(g.m_in.sum()) + float(g.m_rec.sum())
             + float(g.m_out.sum()))
    assert grown > 0.0


def test_evolution_runs_and_tracks_champion():
    """End-to-end smoke on Lander1D: evolve a few generations, champion is
    the best-ever genome (pop axis 1) and evaluates on fresh episodes."""
    cfg = dataclasses.replace(CFG, hidden=4, max_steps=64)
    champ, hist, _ = ne.evolve_population(
        'Lander1D-v0', cfg, max_generations=3, seed=0,
        callback=lambda rec: None)
    assert len(hist) == 3
    assert champ.w_dir.shape[0] == 1
    best_seen = max(h['best_fitness'] for h in hist)
    mean, per = ne.evaluate_champion(champ, 'Lander1D-v0', cfg, reps=3)
    assert per.shape == (3,)  # per-episode returns, spread recoverable
    assert abs(float(per.mean()) - mean) < 1e-5
    assert jnp.isfinite(mean) and jnp.isfinite(best_seen)
    # champion selection is by held-out score, recorded per generation
    assert all('holdout_best' in h for h in hist)


def test_sharded_fitness_matches_single_device():
    """Population evaluation sharded over the 8-device mesh must match the
    unsharded fitness (randomness keyed by global env id — layout
    independence, envs/base.py contract)."""
    from gym_copter_tpu.parallel import sharding as sh
    if len(jax.devices()) < 2:
        pytest.skip('needs the virtual multi-device mesh')
    cfg = dataclasses.replace(CFG, pop_size=16, episode_reps=2)
    g = _pop(cfg=cfg)
    plain = ne.make_fitness_fn('Lander2D-v0', cfg)(g, jnp.int32(3))
    mesh = sh.make_mesh()
    sharded = ne.make_fitness_fn('Lander2D-v0', cfg, mesh=mesh)(
        g, jnp.int32(3))
    assert jnp.allclose(plain, sharded, rtol=1e-5, atol=1e-5)


def test_sharded_fitness_rejects_misaligned_pop():
    from gym_copter_tpu.parallel import sharding as sh
    if len(jax.devices()) != 8:
        pytest.skip('needs the 8-device mesh')
    cfg = dataclasses.replace(CFG, pop_size=6)
    with pytest.raises(ValueError):
        ne.make_fitness_fn('Lander2D-v0', cfg, mesh=sh.make_mesh())


def test_seeded_determinism():
    cfg = dataclasses.replace(CFG, pop_size=4, max_steps=32)
    _, h1, _ = ne.evolve_population('Hover1D-v0', cfg, max_generations=2,
                                    seed=5, callback=lambda r: None)
    _, h2, _ = ne.evolve_population('Hover1D-v0', cfg, max_generations=2,
                                    seed=5, callback=lambda r: None)
    assert h1 == h2
