"""Timing and profiling harness.

The reference has no profiling support at all (SURVEY.md §5 — its only
instruments are stdout reward prints and a wall-clock sync sleep).  This
module provides:

* `time_calls` — wall seconds per call of a JAX computation, each call
  waited for with `jax.block_until_ready`, after one warm-up (compile)
  call;
* `steps_per_sec` — env-steps/s samples from `time_calls`, summarised by
  `robust_stats` (median and MAD-based spread);
* `trace` — thin wrapper over `jax.profiler.trace` for XLA timeline
  captures viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable


def time_calls(fn: Callable[[], object], reps: int) -> list:
    """Wall seconds of each of `reps` calls of `fn`, after one warm-up
    call.  Each call's result is waited for with `jax.block_until_ready`,
    so the time covers the device work, not just its dispatch."""
    import jax

    jax.block_until_ready(fn())  # warm-up / compile
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def robust_stats(samples: list) -> dict:
    """Median + MAD-based spread of samples.

    spread_pct is the normalized median absolute deviation
    (1.4826 * MAD / median, in percent), robust to an occasional outlier
    sample.  Raises ValueError on an empty list: there is no rate to
    report."""
    if not samples:
        raise ValueError('robust_stats: no samples')
    med = statistics.median(samples)
    mad = statistics.median(abs(s - med) for s in samples)
    spread = (1.4826 * mad / med * 100.0) if med > 0 else float('inf')
    return {'median': med, 'spread_pct': spread, 'n': len(samples)}


def steps_per_sec(fn: Callable[[], object], env_steps: int,
                  reps: int = 5) -> dict:
    """Throughput of `fn`, which performs `env_steps` env-steps per call.

    Returns {'steps_per_sec': median of the per-call rates, 'spread_pct':
    MAD-based spread (see `robust_stats`), 'seconds': median seconds per
    call, 'samples': the per-call rates}."""
    secs = time_calls(fn, reps)
    rates = [env_steps / s for s in secs]
    stats = robust_stats(rates)
    return {
        'steps_per_sec': stats['median'],
        'spread_pct': stats['spread_pct'],
        'seconds': statistics.median(secs),
        'samples': rates,
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture an XLA profiler trace into `log_dir`:

        with profiling.trace('/tmp/trace'):
            run_workload()
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
