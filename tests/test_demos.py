"""Demo-CLI smoke tests (headless): the reference's whole demo surface —
constant-thrust landing, demo_pose freeze, vision/DVS views, PID hover, and
the dual-vehicle target chase — must run end-to-end from the command line.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, timeout=600):
    env = dict(os.environ)
    env.pop('XLA_FLAGS', None)
    env['JAX_PLATFORMS'] = 'cpu'
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, script), '--nodisplay', *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=REPO)
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    return r.stdout


def test_lander_demo_freeze():
    out = _run('lander_demo.py', '--freeze', '2,1,8,10,0')
    assert 'frozen pose' in out


def test_lander_demo_vision_and_csv(tmp_path):
    csv = str(tmp_path / 't.csv')
    out = _run('lander_demo.py', '--vision', '--res', '16', '--save', csv)
    assert 'vision:' in out
    assert os.path.exists(csv)


def test_lander_demo_dvs():
    out = _run('lander_demo.py', '--dvs', '--res', '16')
    assert 'DVS:' in out and 'events' in out


def test_hover_demo():
    out = _run('hover_demo.py', '--steps', '120')
    assert 'total_reward' in out


def test_target_demo():
    out = _run('target_demo.py', '--steps', '120')
    assert 'target at' in out


def test_velhold_example(tmp_path):
    """Constant-climb-rate dynamics check (attic/velhold.py analogue): the
    velocity PI must actually hold the climb-rate setpoint."""
    png = str(tmp_path / 'velhold.png')
    env = dict(os.environ)
    env.pop('XLA_FLAGS', None)
    env['JAX_PLATFORMS'] = 'cpu'
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, 'examples/velhold.py'),
         '--duration', '10', '--save', png],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    assert os.path.exists(png)
    rate = float(r.stdout.split('mean climb rate (2nd half) = ')[1].split()[0])
    assert 0.7 < rate < 1.3, r.stdout
