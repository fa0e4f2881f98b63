"""Tests for the compacting simulation driver and the bf16 weight table."""

import jax
import numpy as np

from ssrs_tpu.agents import (TrackParams, simulate_presence,
                             simulate_presence_compacting)
from ssrs_tpu.agents.presence import smooth_presence

GRID = (48, 56)


def _params(nsteps=300, dtype='bfloat16'):
    return TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=1,
                       burnin=int(min(GRID) / 10), nsteps=nsteps,
                       weight_dtype=dtype)


def _fields():
    nrow, ncol = GRID
    y = np.linspace(0, np.pi, nrow)[:, None]
    x = np.linspace(0, 2 * np.pi, ncol)[None, :]
    updraft = (1.0 + 0.8 * np.sin(x) * np.sin(y)).astype(np.float32)
    potential = (np.linspace(1000., 0., nrow)[:, None]
                 * np.ones((1, ncol))).astype(np.float32)
    return updraft, potential


def _starts(n, rng):
    return np.stack([rng.integers(3, 6, n), rng.integers(20, 36, n)],
                    axis=1).astype(np.int32)


def test_compacting_matches_plain_statistically(rng):
    n = 4000
    starts = _starts(n, rng)
    updraft, potential = _fields()
    params = _params()
    p_plain, s_plain = simulate_presence(
        params, starts, jax.random.key(5), updraft=updraft,
        potential=potential)
    p_comp, s_comp = simulate_presence_compacting(
        params, starts, jax.random.key(5), updraft=updraft,
        potential=potential, chunk=64, min_bucket=256)
    a = np.asarray(smooth_presence(np.asarray(p_plain), 3), np.float64)
    b = np.asarray(smooth_presence(np.asarray(p_comp), 3), np.float64)
    a /= a.sum()
    b /= b.sum()
    assert np.abs(a - b).sum() < 0.08
    # every agent contributes at least burn-in + 1 presence points
    burnin = _params().burnin
    assert np.asarray(p_comp).sum() >= n * (burnin + 1)


def test_compacting_deterministic(rng):
    starts = _starts(512, rng)
    updraft, potential = _fields()
    params = _params()
    p1, _ = simulate_presence_compacting(
        params, starts, jax.random.key(9), updraft=updraft,
        potential=potential, chunk=64, min_bucket=128)
    p2, _ = simulate_presence_compacting(
        params, starts, jax.random.key(9), updraft=updraft,
        potential=potential, chunk=64, min_bucket=128)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


def test_compacting_drw(rng):
    starts = _starts(300, rng)
    params = _params()
    presence, steps = simulate_presence_compacting(
        params, starts, jax.random.key(2), chunk=64, min_bucket=64)
    presence = np.asarray(presence)
    assert presence.sum() >= 300
    # northward drift
    assert presence[GRID[0] // 2:, :].sum() > 0


def test_bf16_vs_f32_statistics(rng):
    """bf16 weight quantization must not shift the presence distribution
    beyond statistical noise."""
    n = 4000
    starts = _starts(n, rng)
    updraft, potential = _fields()
    p_bf16, _ = simulate_presence(
        _params(dtype='bfloat16'), starts, jax.random.key(3),
        updraft=updraft, potential=potential)
    p_f32, _ = simulate_presence(
        _params(dtype='float32'), starts, jax.random.key(3),
        updraft=updraft, potential=potential)
    a = np.asarray(smooth_presence(np.asarray(p_bf16), 3), np.float64)
    b = np.asarray(smooth_presence(np.asarray(p_f32), 3), np.float64)
    a /= a.sum()
    b /= b.sum()
    assert np.abs(a - b).sum() < 0.08


def test_matmul_hist_bit_identical_to_scatter(rng):
    """The one-hot MXU matmul presence accumulation must produce EXACTLY
    the counts of the scatter-add: same step function, same RNG stream
    (presence does not consume randomness), only the histogram op
    differs."""
    starts = _starts(600, rng)
    updraft, potential = _fields()
    p_scatter, s1 = simulate_presence_compacting(
        _params()._replace(presence_impl='scatter'), starts,
        jax.random.key(3), updraft=updraft, potential=potential,
        chunk=64, min_bucket=128)
    p_mm, s2 = simulate_presence_compacting(
        _params()._replace(presence_impl='matmul'), starts,
        jax.random.key(3), updraft=updraft, potential=potential,
        chunk=64, min_bucket=128)
    assert int(s1) == int(s2)
    np.testing.assert_array_equal(np.asarray(p_scatter),
                                  np.asarray(p_mm))


def test_tail_runner_bit_identical_to_chunked(rng):
    """With compaction disabled (min_bucket >= N), the one-dispatch tail
    runner applies the same step/key sequence as the chunked host loop,
    so presence counts must be bit-identical."""
    n = 1500
    starts = _starts(n, rng)
    updraft, potential = _fields()
    params = _params(nsteps=256)
    # tail path from the very first iteration
    p_tail, s_tail = simulate_presence_compacting(
        params, starts, jax.random.key(11), updraft=updraft,
        potential=potential, chunk=64, min_bucket=2048)
    # chunked path: same no-compaction setup, tail disabled (negative
    # threshold) so the host loop dispatches every chunk
    p_chunk, s_chunk = simulate_presence_compacting(
        params, starts, jax.random.key(11), updraft=updraft,
        potential=potential, chunk=64, min_bucket=2048, tail_bucket=-1)
    assert int(s_tail) == int(s_chunk)
    np.testing.assert_array_equal(np.asarray(p_tail),
                                  np.asarray(p_chunk))


def test_prepare_starts_bit_identical(rng):
    """Device-resident starts (prepare_starts, the multi-case hoisting
    pattern) must produce bit-identical presence to passing the raw
    numpy batch: the device passthrough changes where the upload
    happens, never the agents."""
    from ssrs_tpu.agents import prepare_starts

    n = 1500
    starts = _starts(n, rng)
    updraft, potential = _fields()
    params = _params(nsteps=256)
    p_np, s_np = simulate_presence_compacting(
        params, starts, jax.random.key(7), updraft=updraft,
        potential=potential, chunk=64, min_bucket=256)
    starts_dev, valid_dev = prepare_starts(starts)
    p_dev, s_dev = simulate_presence_compacting(
        params, starts_dev, jax.random.key(7), updraft=updraft,
        potential=potential, chunk=64, min_bucket=256, valid=valid_dev)
    assert int(s_np) == int(s_dev)
    np.testing.assert_array_equal(np.asarray(p_np), np.asarray(p_dev))


def test_driver_edge_cases(rng):
    """Single agent, nsteps < chunk, nsteps == 0-ish tiny caps: the
    compacting driver's host step counter and tail logic must not
    over- or under-run."""
    updraft, potential = _fields()
    for n, nsteps, chunk in ((1, 5, 64), (3, 70, 64), (257, 1, 64)):
        starts = _starts(n, rng)
        params = _params(nsteps=nsteps)
        p, s = simulate_presence_compacting(
            params, starts, jax.random.key(2), updraft=updraft,
            potential=potential, chunk=chunk, min_bucket=64)
        p = np.asarray(p)
        assert p.sum() >= n               # starts always counted
        assert p.sum() <= n * (nsteps + 1)
        assert int(s) >= min(nsteps, 1)


def test_presence_impl_none_stays_zero_xla(rng):
    """'no presence in the step (caller accumulates)' must hold through
    the XLA-engine compacting driver too (flush_pending honors 'none')."""
    updraft, potential = _fields()
    starts = _starts(64, rng)
    params = _params(nsteps=100)._replace(presence_impl='none',
                                          step_impl='xla')
    p, s = simulate_presence_compacting(
        params, starts, jax.random.key(1), updraft=updraft,
        potential=potential, chunk=16, min_bucket=32)
    assert int(s) > 0
    assert int(np.asarray(p).sum()) == 0
