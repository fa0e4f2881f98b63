"""chip_smoke.py off the card: it must refuse a CPU-only JAX, and its
phase-1 checks (device results vs the plain references) must hold at tiny
widths on the CPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

SHAPE = (60, 72)


def test_refuses_cpu_without_result_line():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, os.path.join(REPO, 'chip_smoke.py')],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert 'needs an NVIDIA GPU' in out.stdout


def _cond_pot():
    cond = cs.wy_conductivity(SHAPE)
    pot = np.linspace(1000., 0., SHAPE[0], dtype=np.float32)[:, None] \
        * np.ones((1, SHAPE[1]), np.float32)
    return cond, pot


@pytest.mark.parametrize('check', ['ds', 'terrain', 'weights', 'solve',
                                   'presence', 'step_oracle'])
def test_phase1_check_at_tiny_width(check):
    checks = cs.Checks()
    if check == 'ds':
        cs.check_ds(checks, n=20_000)
    elif check == 'terrain':
        cs.check_terrain(checks, SHAPE)
    elif check == 'weights':
        cs.check_weights(checks, *_cond_pot())
    elif check == 'solve':
        pot = cs.check_solve(checks, cs.wy_conductivity(SHAPE))
        assert pot.shape == SHAPE and np.isfinite(pot).all()
    elif check == 'presence':
        cs.check_presence_paths(checks, SHAPE, 5000)
    else:
        cs.check_step_vs_oracle(checks, *_cond_pot(), n_device=20_000,
                                n_oracle=3000, nsteps=120)
    assert not checks.failed, checks.failed


def test_checks_record_failures():
    checks = cs.Checks()
    assert checks.check('within', 1., 1.)
    assert not checks.check('over', 2., 1.)
    assert not checks.require('false', False)
    assert checks.failed == ['over', 'false']


def test_trace_summary_reads_a_cpu_trace(tmp_path, capsys):
    """The trace reduction finds the profile and reports that a CPU trace
    has no GPU plane (on the card it lists the step's kernels)."""
    f = jax.jit(lambda x: (x * 2.).sum())
    x = jax.numpy.ones((64,))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    cs.trace_device_summary(str(tmp_path))
    assert 'no GPU plane' in capsys.readouterr().out
