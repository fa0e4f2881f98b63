"""The harness end to end on the CPU at a tiny size: it refuses a machine
without a GPU; past the device check a sound run reads correct, and the
lower-precision control and each fault a cell can have read not correct.

The tiny cells (``tests/data``) are the WY configuration on a 50 x 60 grid
with 2000 tracks, on the same compacting engine path as the benchmark's
cell. Their limits are set for that size, between the sound readings
and the control's and the faults'.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest

from benchmark import run, spec

DATA = os.path.join(spec.BENCH_DIR, 'tests', 'data')


CONFIG = {'tiny_uniform': 'tiny_direct', 'tiny_sweep': 'tiny'}


def tiny(name, control=False, trace=0):
    """Run tiny cell ``name`` past the device check; the result line.
    ``tiny_uniform`` solves the potential on the host in float64, as the
    WY cell does; ``tiny_sweep`` on the device."""
    import io
    from contextlib import redirect_stdout
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(['--workload', name, '--seed', '4000000003',
                       '--seconds', '0.5', '--trace', str(trace)],
                      require_gpu=False, bench_dir=DATA, control=control,
                      entry={'name': name, 'config': CONFIG[name],
                             'traffic': name, 'chips': 1})
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def failing(result):
    return {k for k, v in result['checks'].items() if v['value'] > v['limit']}


def test_refuses_a_machine_without_a_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.BENCH_DIR, 'run.py'),
         '--workload', 'wy_uniform_100k', '--seed', '1', '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert '{' not in proc.stdout
    assert 'needs 1 NVIDIA GPU' in proc.stderr


@pytest.mark.parametrize('name', ['tiny_uniform', 'tiny_sweep'])
def test_sound_run_is_correct(name):
    result = tiny(name)
    assert result['correct'], result['checks']
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert set(result['metrics']) == {'study_s', 'setup_s'}
    assert list(result)[-1] == 'checks'


def test_traced_run_reports_per_layer_metrics_and_breakdown():
    result = tiny('tiny_uniform', trace=1)
    assert result['correct'], result['checks']
    assert 'potential.host_solve_s' in result['metrics']
    assert result['device']['window_s'] > 0
    assert result['breakdown']['idle_gaps']


def test_control_is_not_correct():
    """One precision step below the stated one: the bfloat16 weight
    table, and the reference in bfloat16 / float32 in the program's
    place."""
    result = tiny('tiny_uniform', control=True)
    assert not result['correct']
    assert {'updraft', 'potential', 'weights', 'summary'} <= \
        failing(result)


def test_fault_step_returns_state_unchanged(monkeypatch):
    import ssrs_tpu.agents.simulate as simulate

    def still(params, base_flat, dirp, table, state, chunk):
        return state, jnp.sum(state.alive)
    monkeypatch.setattr(simulate, '_run_chunk', still)
    monkeypatch.setattr(simulate, '_run_tail', still)
    result = tiny('tiny_uniform')
    assert not result['correct']
    assert 'presence_l1' in failing(result)


def test_fault_half_the_tracks_left_out(monkeypatch):
    import ssrs_tpu.agents as agents
    orig = agents.simulate_presence_compacting

    def half(params, starts, key, **kw):
        return orig(params, starts[: len(starts) // 2], key, **kw)
    monkeypatch.setattr(agents, 'simulate_presence_compacting', half)
    result = tiny('tiny_uniform')
    assert not result['correct']
    assert {'start_deficit', 'moves_rel'} <= failing(result)


def test_fault_potential_altered_where_it_is_produced(monkeypatch):
    import ssrs_tpu.potential as potential
    orig = potential.solve_potential_refined

    def shifted(cond, bmask, bvals, **kw):
        pot, resid = orig(cond, bmask, bvals, **kw)
        return jnp.where(jnp.asarray(bmask), pot, pot + 50.), resid
    monkeypatch.setattr(potential, 'solve_potential_refined', shifted)
    result = tiny('tiny_sweep')
    assert not result['correct']
    assert 'potential' in failing(result)
