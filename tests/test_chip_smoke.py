"""chip_smoke.py refuses to report a result without a GPU or without the
rest of the repository."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('where', ['repo', 'alone'])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    script = os.path.join(REPO, 'chip_smoke.py')
    cwd = REPO
    if where == 'alone':
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('PYTHONPATH', None)
    env.pop('XLA_FLAGS', None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    if where == 'repo':
        assert 'no GPU' in r.stderr
