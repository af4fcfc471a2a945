"""Timing harness sanity (utils/profiling.py)."""

import time

import jax.numpy as jnp
import pytest

from gym_copter_tpu.utils import profiling


def test_steps_per_sec_recovers_rate():
    """A synthetic workload of known duration: the median rate is the
    env-steps per call over the seconds per call."""
    per_call = 5e-3

    def fn():
        time.sleep(per_call)
        return jnp.zeros(())

    res = profiling.steps_per_sec(fn, env_steps=1000, reps=3)
    assert len(res['samples']) == 3
    assert per_call <= res['seconds'] < 4 * per_call
    assert 1000 / (4 * per_call) < res['steps_per_sec'] <= 1000 / per_call


def test_robust_stats_mad_resists_outliers():
    samples = [7.0, 7.1, 6.9, 7.05, 37.0]  # one outlier sample
    stats = profiling.robust_stats(samples)
    assert 6.9 <= stats['median'] <= 7.1
    assert stats['spread_pct'] < 5.0  # stddev would report >100%


def test_robust_stats_raises_without_samples():
    with pytest.raises(ValueError, match='no samples'):
        profiling.robust_stats([])


def test_time_calls_warms_up_and_waits():
    calls = []

    def fn():
        calls.append(1)
        time.sleep(0.001)
        return jnp.arange(3) * 2

    d = profiling.time_calls(fn, reps=3)
    assert len(calls) == 4  # 1 warm-up + 3 timed
    assert len(d) == 3 and min(d) >= 0.001
