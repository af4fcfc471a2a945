"""Batched adaptive disturbance-rejection control (PES-style learning).

Batched counterpart of the reference's Nengo adaptive hover experiment
(attic/nengo/adaptive.py:49-122 + copter.py:16-57): a PD altitude
controller augmented by an online-learned adaptive term that cancels
unmodeled steady-state effort (gravity offset + an injected wind force).

The Nengo original runs ONE plant under a 1000-neuron spiking ensemble
with the PES rule (dw = lr * error * activities) at 1 kHz host stepping.
Here the same learning rule runs as dense batched linear regression on RBF
features inside one `lax.scan`: B independent plants — each with its OWN
wind force and its OWN adapting weight vector — step in lockstep on the
device, so a whole disturbance sweep costs one compiled rollout.

Same signal wiring as the reference:
  * u_pd   = k_p * (target - z) + k_d * (0 - dz)      (adaptive.py:72-78)
  * error  = -u_pd                                     (adaptive.py:110-115)
  * dw     = lr * error * phi(z)   -> u_extra = w . phi(z)
The adaptive term therefore learns to absorb all steady-state effort
(hover thrust + wind), returning the PD output to zero and killing the
P-controller's steady-state tracking error.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from gym_copter_tpu.core import dynamics
from gym_copter_tpu.core.types import EnvParams
from gym_copter_tpu.envs import base, tasks


class AdaptiveConfig(NamedTuple):
    target: float = 5.0          # altitude setpoint (m)
    k_p: float = 5e-3            # PD gains in motor units / m, / (m/s)
    k_d: float = 8e-3
    learning_rate: float = 1e-3  # PES rate
    n_features: int = 16         # RBF centers over altitude
    feature_lo: float = 0.0
    feature_hi: float = 10.0
    feature_width: float = 1.0


def rbf_features(z, cfg: AdaptiveConfig):
    """(B,) altitude -> (n, B) Gaussian RBF activations — the dense
    analogue of the Nengo ensemble's tuning-curve activities."""
    centers = jnp.linspace(cfg.feature_lo, cfg.feature_hi, cfg.n_features,
                           dtype=z.dtype)
    d = (z[None, :] - centers[:, None]) / jnp.asarray(cfg.feature_width,
                                                      z.dtype)
    return jnp.exp(-d * d)


def run(env_params: EnvParams, wind_forces, num_steps: int,
        cfg: AdaptiveConfig = AdaptiveConfig(), adapt: bool = True,
        start_altitude: Optional[float] = None, record_every: int = 1):
    """Run B = len(wind_forces) adaptive-hover plants for `num_steps`.

    wind_forces: (B,) sustained vertical force in newtons (the reference's
    'Wind Force' slider, copter.py:44-46), applied every step through the
    dynamics' perturbation input.

    Returns a dict of (T, B) histories: z (altitude), u_pd, u_extra, and
    the final (n, B) weights.  Everything runs as one jitted lax.scan.
    """
    wind_forces = jnp.asarray(wind_forces, jnp.float32)
    b = wind_forces.shape[0]
    spec = tasks.HOVER_1D
    key = jax.random.PRNGKey(0)
    env_ids = jnp.arange(b, dtype=jnp.int32)
    alt0 = cfg.target if start_altitude is None else start_altitude

    state, obs = base.reset(key, env_ids, jnp.zeros(b, jnp.int32),
                            env_params, spec,
                            pose=(0.0, 0.0, alt0, 0.0, 0.0),
                            perturb_force=jnp.zeros((6, b)))
    # sustained wind: a (6, B) force with only the Z slot set, re-applied
    # before every step (the env clears instantaneous perturbations)
    wind6 = jnp.zeros((6, b), jnp.float32).at[2].set(wind_forces)

    w0 = jnp.zeros((cfg.n_features, b), jnp.float32)

    @jax.jit
    def rollout(state, obs, w):
        def step_fn(carry, _):
            state, obs, w = carry
            z, dz = -obs[0], -obs[1]            # NED -> ENU (copter.py:36-38)
            u_pd = cfg.k_p * (cfg.target - z) + cfg.k_d * (0.0 - dz)
            phi = rbf_features(z, cfg)
            u_extra = jnp.sum(w * phi, axis=0) if adapt else jnp.zeros(b)
            u = jnp.clip(u_pd + u_extra, 0.0, 1.0)  # copter.py:30

            # PES descends the error: dw = -lr * error * activities with
            # error = -u_pd (adaptive.py:110-115 feeds -u into the rule),
            # i.e. dw = +lr * u_pd * phi — positive PD effort grows the
            # adaptive term until it absorbs the steady-state load
            if adapt:
                w = w + cfg.learning_rate * u_pd[None, :] * phi

            # inject the sustained wind through the perturbation input
            dyn = dynamics.perturb(state.dyn, wind6, env_params.vehicle)
            state = state._replace(dyn=dyn)
            state, ts = base.step(state, u[None, :], key, env_ids,
                                  env_params, spec)
            out = (z, u_pd, u_extra)
            return (state, ts.obs, w), out

        (state, obs, w), hist = jax.lax.scan(step_fn, (state, obs, w),
                                             None, length=num_steps)
        return state, w, hist

    _, w, (z_hist, u_pd_hist, u_extra_hist) = rollout(state, obs, w0)
    return {
        'z': z_hist[::record_every],
        'u_pd': u_pd_hist[::record_every],
        'u_extra': u_extra_hist[::record_every],
        'weights': w,
    }


def tracking_error(history, cfg: AdaptiveConfig, window: int = 500):
    """Mean |altitude - target| over the last `window` recorded steps,
    per plant — the experiment's success metric."""
    z = history['z'][-window:]
    return jnp.mean(jnp.abs(z - cfg.target), axis=0)
