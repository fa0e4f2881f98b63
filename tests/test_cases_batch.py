"""Tests for the batched multi-case (direction sweep) simulation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssrs_tpu.agents import (TrackParams, directional_probs,
                             prepared_weights, simulate_presence,
                             simulate_presence_cases,
                             simulate_presence_cases_compacting,
                             simulate_presence_compacting)

GRID = (48, 56)


def _params(nsteps=150):
    return TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=1,
                       burnin=int(min(GRID) / 10), nsteps=nsteps)


def test_direction_sweep_shapes_and_drift(rng):
    nrow, ncol = GRID
    y = np.linspace(0, np.pi, nrow)[:, None]
    x = np.linspace(0, 2 * np.pi, ncol)[None, :]
    updraft = (1.0 + 0.8 * np.sin(x) * np.sin(y)).astype(np.float32)
    params = _params()

    dirns = [0., 90.]
    dirps = np.stack([directional_probs(d) for d in dirns])
    # direction-0 potential: northward ramp; direction-90: eastward ramp
    pot_n = (np.linspace(1000., 0., nrow)[:, None]
             * np.ones((1, ncol))).astype(np.float32)
    pot_e = (np.ones((nrow, 1))
             * np.linspace(1000., 0., ncol)[None, :]).astype(np.float32)
    tables = jnp.stack([
        prepared_weights(updraft, pot_n, jnp.asarray(dirps[0]),
                         'bfloat16'),
        prepared_weights(updraft, pot_e, jnp.asarray(dirps[1]),
                         'bfloat16')])

    n = 600
    starts = np.stack([rng.integers(20, 28, n), rng.integers(24, 32, n)],
                      axis=1).astype(np.int32)
    keys = jax.random.split(jax.random.key(0), 2)
    presence, steps = simulate_presence_cases(
        params, tables, jnp.asarray(dirps), jnp.asarray(starts), keys)
    presence = np.asarray(presence)
    assert presence.shape == (2, nrow, ncol)
    # case 0 drifts north (mass in the north half beyond the south half)
    north_mass = presence[0, nrow // 2:, :].sum()
    south_mass = presence[0, :nrow // 2, :].sum()
    assert north_mass > south_mass
    # case 1 drifts east
    east_mass = presence[1, :, ncol // 2:].sum()
    west_mass = presence[1, :, :ncol // 2].sum()
    assert east_mass > west_mass


def test_sweep_case_matches_single(rng):
    """A single-case sweep must reproduce the single-case engine exactly
    (same key, same table)."""
    nrow, ncol = GRID
    updraft = np.ones(GRID, np.float32)
    pot = (np.linspace(1000., 0., nrow)[:, None]
           * np.ones((1, ncol))).astype(np.float32)
    params = _params()
    dirp = jnp.asarray(directional_probs(0.))
    table = prepared_weights(updraft, pot, dirp, params.weight_dtype)

    n = 300
    starts = np.stack([rng.integers(4, 8, n), rng.integers(20, 30, n)],
                      axis=1).astype(np.int32)
    key = jax.random.key(7)
    p_single, _ = simulate_presence(params, starts, key, updraft=updraft,
                                    potential=pot)
    p_sweep, _ = simulate_presence_cases(
        params, table[None], dirp[None], jnp.asarray(starts), key[None])
    np.testing.assert_array_equal(np.asarray(p_single),
                                  np.asarray(p_sweep)[0])


def _drift_field_tables(rng):
    nrow, ncol = GRID
    y = np.linspace(0, np.pi, nrow)[:, None]
    x = np.linspace(0, 2 * np.pi, ncol)[None, :]
    updraft = (1.0 + 0.8 * np.sin(x) * np.sin(y)).astype(np.float32)
    dirns = [0., 90.]
    dirps = np.stack([directional_probs(d) for d in dirns])
    pot_n = (np.linspace(1000., 0., nrow)[:, None]
             * np.ones((1, ncol))).astype(np.float32)
    pot_e = (np.ones((nrow, 1))
             * np.linspace(1000., 0., ncol)[None, :]).astype(np.float32)
    tables = [
        prepared_weights(updraft, pot_n, jnp.asarray(dirps[0]),
                         'float32'),
        prepared_weights(updraft, pot_e, jnp.asarray(dirps[1]),
                         'float32')]
    return tables, dirps


def test_cases_compacting_matches_single(rng):
    """The interleaved multi-case compacting driver must reproduce the
    single-case compacting driver bit-exactly per case — same key, same
    table, same bucket ladder (VERDICT r3 item 1)."""
    params = _params(nsteps=700)  # long cap so compaction triggers
    tables, dirps = _drift_field_tables(rng)
    n = 600
    starts = np.stack([rng.integers(20, 28, n), rng.integers(24, 32, n)],
                      axis=1).astype(np.int32)
    keys = jax.random.split(jax.random.key(3), 2)

    p_multi, s_multi = simulate_presence_cases_compacting(
        params, tables, starts, list(keys),
        dirps=jnp.asarray(dirps), chunk=64, min_bucket=128)
    p_multi = np.asarray(p_multi)
    assert p_multi.shape == (2,) + GRID
    for i in range(2):
        p_one, s_one = simulate_presence_compacting(
            params, starts, keys[i], base_flat=tables[i],
            dirp=jnp.asarray(dirps[i]), chunk=64, min_bucket=128)
        np.testing.assert_array_equal(p_multi[i], np.asarray(p_one))
    # drift sanity: case 0 north, case 1 east (as in the vmapped engine)
    nrow, ncol = GRID
    assert p_multi[0, nrow // 2:, :].sum() > p_multi[0, :nrow // 2, :].sum()
    assert p_multi[1, :, ncol // 2:].sum() > p_multi[1, :, :ncol // 2].sum()


def test_cases_compacting_device_spread_bit_identical(rng):
    """Case parallelism over devices (the device analog of the
    reference's one-process-per-case pool): spreading cases over the
    8-device mesh must be BIT-identical per case to the single-device
    driver — placement does not change the math."""
    params = _params(nsteps=400)
    tables, dirps = _drift_field_tables(rng)
    n = 600
    starts = np.stack([rng.integers(20, 28, n), rng.integers(24, 32, n)],
                      axis=1).astype(np.int32)
    keys = jax.random.split(jax.random.key(5), 2)
    kw = dict(dirps=jnp.asarray(dirps), chunk=64, min_bucket=128)
    p_one, s_one = simulate_presence_cases_compacting(
        params, tables, starts, list(keys), **kw)
    p_spread, s_spread = simulate_presence_cases_compacting(
        params, tables, starts, list(keys), devices=jax.devices(), **kw)
    np.testing.assert_array_equal(np.asarray(p_one),
                                  np.asarray(p_spread))
    np.testing.assert_array_equal(np.asarray(s_one),
                                  np.asarray(s_spread))


def test_cases_compacting_per_case_starts(rng):
    """Per-case starts as a (C, N, 2) array AND as a list of (N, 2)
    arrays both route to the per-case path, agree with each other, and
    reproduce the single-case driver per case."""
    params = _params(nsteps=300)
    tables, dirps = _drift_field_tables(rng)
    n = 400
    s0 = np.stack([rng.integers(20, 28, n), rng.integers(24, 32, n)],
                  axis=1).astype(np.int32)
    s1 = np.stack([rng.integers(8, 16, n), rng.integers(10, 20, n)],
                  axis=1).astype(np.int32)
    keys = jax.random.split(jax.random.key(9), 2)
    kw = dict(dirps=jnp.asarray(dirps), chunk=64, min_bucket=128)
    p_arr, _ = simulate_presence_cases_compacting(
        params, tables, np.stack([s0, s1]), list(keys), **kw)
    p_list, _ = simulate_presence_cases_compacting(
        params, tables, [s0, s1], list(keys), **kw)
    np.testing.assert_array_equal(np.asarray(p_arr), np.asarray(p_list))
    for i, s in enumerate((s0, s1)):
        p_one, _ = simulate_presence_compacting(
            params, s, keys[i], base_flat=tables[i],
            dirp=jnp.asarray(dirps[i]), chunk=64, min_bucket=128)
        np.testing.assert_array_equal(np.asarray(p_arr)[i],
                                      np.asarray(p_one))


def test_compacting_knob_validation(rng):
    """Bad tail_bucket values and mismatched per-case starts raise clear
    ValueErrors, not TypeErrors deep in a comparison or broadcast."""
    params = _params(nsteps=50)
    tables, dirps = _drift_field_tables(rng)
    starts = np.stack([rng.integers(20, 28, 64),
                       rng.integers(24, 32, 64)],
                      axis=1).astype(np.int32)
    keys = jax.random.split(jax.random.key(1), 2)
    with pytest.raises(ValueError, match='tail_bucket'):
        simulate_presence_cases_compacting(
            params, tables, starts, list(keys),
            dirps=jnp.asarray(dirps), tail_bucket='never')
    with pytest.raises(ValueError, match='tail_bucket'):
        simulate_presence_compacting(
            params, starts, keys[0], base_flat=tables[0],
            dirp=jnp.asarray(dirps[0]), tail_bucket='sometimes')
    with pytest.raises(ValueError, match='per-case'):
        simulate_presence_cases_compacting(
            params, tables, [starts], list(keys),
            dirps=jnp.asarray(dirps))


def test_cases_compacting_statistics_match_vmapped(rng):
    """Presence statistics from the compacting multi-case driver agree
    with the vmapped lockstep engine within sampling noise (different
    RNG partitioning, same stochastic process): compare per-case
    north/east drift fractions."""
    params = _params(nsteps=200)
    tables, dirps = _drift_field_tables(rng)
    n = 2000
    starts = np.stack([rng.integers(20, 28, n), rng.integers(24, 32, n)],
                      axis=1).astype(np.int32)
    keys = jax.random.split(jax.random.key(11), 2)

    p_a, _ = simulate_presence_cases(
        params, jnp.stack(tables), jnp.asarray(dirps),
        jnp.asarray(starts), keys)
    p_b, _ = simulate_presence_cases_compacting(
        params, tables, starts, list(keys), dirps=jnp.asarray(dirps),
        chunk=64, min_bucket=256)
    p_a, p_b = np.asarray(p_a, np.float64), np.asarray(p_b, np.float64)
    nrow, ncol = GRID
    for i, (sl_hi, axis) in enumerate([
            (np.s_[:, nrow // 2:, :], 'north'),
            (np.s_[:, :, ncol // 2:], 'east')]):
        frac_a = p_a[sl_hi][i].sum() / p_a[i].sum()
        frac_b = p_b[sl_hi][i].sum() / p_b[i].sum()
        assert abs(frac_a - frac_b) < 0.03, (axis, frac_a, frac_b)
