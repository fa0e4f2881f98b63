"""XLA agent-step engine: delayed-histogram bookkeeping and input
validation through the jitted and compacting drivers."""

import jax
import numpy as np
import pytest

from ssrs_tpu.agents.simulate import (TrackParams, simulate_presence,
                                      simulate_presence_compacting)

GRID = (48, 56)
N = 2048


def _params(nsteps=150, nu=1., k=2):
    return TrackParams(grid_shape=GRID, move_dirn=0., nu=nu, memory_k=k,
                       burnin=4, nsteps=nsteps, weight_dtype='float32',
                       step_impl='xla')


def _fields(rng):
    nrow, ncol = GRID
    up = (0.5 + rng.random((nrow, ncol))).astype(np.float32)
    pot = (np.linspace(1000., 0., nrow)[:, None]
           * np.ones((1, ncol), np.float32))
    return up, pot


def _starts(n, rng):
    return np.stack([rng.integers(3, 8, n), rng.integers(10, 46, n)],
                    axis=1).astype(np.int32)


def test_delayed_hist_total_is_conserved(rng):
    """Presence total == sum over agents of (1 start + alive steps):
    the delayed accumulation misses nothing at the end of a run."""
    up, pot = _fields(rng)
    starts = _starts(N, rng)
    params = _params(nsteps=400)
    p, s = simulate_presence(params, starts, jax.random.key(5),
                             updraft=up, potential=pot, chunk=64,
                             record_tracks=False)
    # run again with track recording to get exact lengths
    p2, s2, tracks, lengths = simulate_presence(
        params, starts, jax.random.key(5), updraft=up, potential=pot,
        record_tracks=True)
    assert int(np.asarray(p2).sum()) == int(np.asarray(lengths).sum())
    np.testing.assert_array_equal(np.asarray(p), np.asarray(p2))


def test_presence_impl_none_stays_zero(rng):
    """presence_impl='none' must accumulate nothing through the
    compacting driver (regression: flush_pending ignored 'none' and
    histogrammed compaction-boundary snapshots)."""
    up, pot = _fields(rng)
    starts = _starts(N, rng)
    params = _params(nsteps=80)._replace(presence_impl='none')
    p, s = simulate_presence_compacting(
        params, starts, jax.random.key(5), updraft=up, potential=pot,
        chunk=16, min_bucket=1024)
    assert int(s) > 0
    assert int(np.asarray(p).sum()) == 0


def test_accepts_list_starts(rng):
    """List-of-pairs starts through the compacting driver give the same
    presence as the equivalent array (the driver converts them before
    reading a shape)."""
    up, pot = _fields(rng)
    starts_np = _starts(700, rng)
    params = _params(nsteps=40)
    p_list, _ = simulate_presence_compacting(
        params, starts_np.tolist(), jax.random.key(9), updraft=up,
        potential=pot, chunk=16, min_bucket=1024)
    p_np, _ = simulate_presence_compacting(
        params, starts_np, jax.random.key(9), updraft=up,
        potential=pot, chunk=16, min_bucket=1024)
    np.testing.assert_array_equal(np.asarray(p_list), np.asarray(p_np))


def test_unknown_presence_impl_raises(rng):
    """Pruned/typo presence_impl values must raise, not silently run the
    scatter path under the wrong label."""
    up, pot = _fields(rng)
    starts = _starts(N, rng)
    params = _params(nsteps=10)._replace(presence_impl='chunk-hist')
    with pytest.raises(ValueError, match='chunk-hist'):
        simulate_presence_compacting(
            params, starts, jax.random.key(0), updraft=up, potential=pot,
            chunk=8, min_bucket=1024)
