"""Test configuration: run everything on a virtual 8-device CPU mesh.

The reference has no tests at all (SURVEY.md §4); this suite is built on the
strategy SURVEY.md §4 prescribes: float64 oracle parity, property tests on
the branchless status machine, and fake-multi-device sharding tests via
``--xla_force_host_platform_device_count`` — so the full sharded path is
exercised without accelerator hardware.  float64 is enabled globally; the
engine is dtype-explicit so float32 behavior is still testable.  The GPU
path is checked on the card by ``chip_smoke.py``.
"""

import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
_flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (
        _flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

jax.config.update('jax_enable_x64', True)
