"""The entry scripts' compilation-cache rule (utils/compile_cache.py)."""

import os

import jax
import pytest

from gym_copter_tpu.utils import compile_cache


@pytest.mark.parametrize('env_dir', [None, '/some/shared/cache'])
def test_cache_dir_follows_env_var_else_repo_path(monkeypatch, env_dir):
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
    try:
        got = compile_cache.enable()
        if env_dir is None:
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert got == os.path.join(repo, '.jax_cache')
            assert jax.config.jax_compilation_cache_dir == got
        else:
            # JAX reads the variable itself; nothing is set in code
            assert got == env_dir
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update('jax_compilation_cache_dir', before)
