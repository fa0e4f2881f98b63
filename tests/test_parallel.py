"""Multi-device sharding tests on the 8-virtual-device CPU mesh."""

import jax
import numpy as np

from ssrs_tpu.agents import TrackParams, simulate_presence
from ssrs_tpu.parallel import (make_mesh, pad_to_multiple,
                               simulate_presence_sharded,
                               simulate_presence_sharded_compacting)

GRID = (48, 56)


def _params(nsteps=120):
    return TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=1,
                       burnin=int(min(GRID) / 10), nsteps=nsteps)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_pad_to_multiple():
    starts = np.arange(10).reshape(5, 2).astype(np.int32)
    padded, valid = pad_to_multiple(starts, 8)
    assert padded.shape == (8, 2)
    assert valid.sum() == 5 and not valid[5:].any()
    padded2, valid2 = pad_to_multiple(starts, 5)
    assert padded2.shape == (5, 2) and valid2.all()


def test_sharded_matches_presence_total(rng):
    """Sharded run must produce a valid presence map whose total equals
    starts + moves, with padding agents contributing nothing."""
    n = 100  # not divisible by 8 -> exercises padding
    starts = np.stack([rng.integers(3, 6, n), rng.integers(20, 30, n)],
                      axis=1).astype(np.int32)
    presence, steps = simulate_presence_sharded(
        _params(), starts, jax.random.key(3))
    presence = np.asarray(presence)
    assert presence.sum() >= n  # every real agent contributes its start
    assert presence[GRID[0] // 2:, :].sum() > 0  # northward drift happened


def test_sharded_deterministic(rng):
    n = 64
    starts = np.stack([rng.integers(3, 6, n), rng.integers(20, 30, n)],
                      axis=1).astype(np.int32)
    p1, _ = simulate_presence_sharded(_params(), starts, jax.random.key(5))
    p2, _ = simulate_presence_sharded(_params(), starts, jax.random.key(5))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


def test_sharded_fluidflow(rng):
    nrow, ncol = GRID
    y = np.linspace(0, np.pi, nrow)[:, None]
    x = np.linspace(0, 2 * np.pi, ncol)[None, :]
    updraft = (1.0 + 0.8 * np.sin(x) * np.sin(y)).astype(np.float32)
    potential = (np.linspace(1000., 0., nrow)[:, None]
                 * np.ones((1, ncol))).astype(np.float32)
    n = 16384
    starts = np.stack([rng.integers(3, 6, n), rng.integers(20, 30, n)],
                      axis=1).astype(np.int32)
    presence, _ = simulate_presence_sharded(
        _params(), starts, jax.random.key(7), updraft=updraft,
        potential=potential)
    presence = np.asarray(presence)
    assert presence.sum() > n
    # statistical agreement with the single-device engine: different RNG
    # partitioning -> distributional comparison; at 16k agents the
    # marginal L1 tolerance sits within quoted sampling noise (two
    # independent single-device seeds measure ~0.01-0.02 here)
    p_single, _ = simulate_presence(_params(), starts, jax.random.key(7),
                                    updraft=updraft, potential=potential)
    a = presence / presence.sum()
    b = np.asarray(p_single) / np.asarray(p_single).sum()
    assert np.abs(a.sum(axis=1) - b.sum(axis=1)).sum() < 0.03
    assert np.abs(a.sum(axis=0) - b.sum(axis=0)).sum() < 0.03
    # and a KS statistic on the row-marginal CDFs
    ks = np.abs(np.cumsum(a.sum(axis=1)) - np.cumsum(b.sum(axis=1))).max()
    assert ks < 0.01


def test_sharded_deterministic_two_mesh_sizes(rng):
    """Seeded bit-determinism of the sharded engine at two mesh sizes
    (results differ ACROSS mesh sizes by design — per-device streams —
    but must be exactly reproducible at each)."""
    n = 256
    starts = np.stack([rng.integers(3, 6, n), rng.integers(20, 30, n)],
                      axis=1).astype(np.int32)
    for ndev in (2, 8):
        mesh = make_mesh(ndev)
        p1, s1 = simulate_presence_sharded(_params(), starts,
                                           jax.random.key(11), mesh=mesh)
        p2, s2 = simulate_presence_sharded(_params(), starts,
                                           jax.random.key(11), mesh=mesh)
        np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
        assert int(s1) == int(s2)


def _drift_fields():
    nrow, ncol = GRID
    y = np.linspace(0, np.pi, nrow)[:, None]
    x = np.linspace(0, 2 * np.pi, ncol)[None, :]
    updraft = (1.0 + 0.8 * np.sin(x) * np.sin(y)).astype(np.float32)
    potential = (np.linspace(1000., 0., nrow)[:, None]
                 * np.ones((1, ncol))).astype(np.float32)
    return updraft, potential


def test_compacting_sharded_statistics(rng):
    """The compacting sharded driver (VERDICT r3 item 2) must be
    statistically equivalent to the plain sharded engine: same
    stochastic process, different RNG partitioning across the bucket
    ladder. Compare marginal distributions at 16k agents."""
    updraft, potential = _drift_fields()
    n = 16384
    starts = np.stack([rng.integers(3, 6, n), rng.integers(20, 30, n)],
                      axis=1).astype(np.int32)
    params = _params(nsteps=512)
    p_plain, _ = simulate_presence_sharded(
        params, starts, jax.random.key(7), updraft=updraft,
        potential=potential)
    p_comp, s_comp = simulate_presence_sharded_compacting(
        params, starts, jax.random.key(7), updraft=updraft,
        potential=potential, chunk=64, min_bucket=128)
    p_plain, p_comp = (np.asarray(p_plain, np.float64),
                       np.asarray(p_comp, np.float64))
    assert p_comp.shape == GRID
    assert p_comp.sum() >= n
    a = p_comp / p_comp.sum()
    b = p_plain / p_plain.sum()
    assert np.abs(a.sum(axis=1) - b.sum(axis=1)).sum() < 0.03
    assert np.abs(a.sum(axis=0) - b.sum(axis=0)).sum() < 0.03
    ks = np.abs(np.cumsum(a.sum(axis=1)) - np.cumsum(b.sum(axis=1))).max()
    assert ks < 0.01


def test_compacting_sharded_deterministic(rng):
    """Bit-reproducibility for a fixed key/mesh/ladder (tail_bucket
    default is the deterministic min_bucket switch)."""
    updraft, potential = _drift_fields()
    n = 2048
    starts = np.stack([rng.integers(3, 6, n), rng.integers(20, 30, n)],
                      axis=1).astype(np.int32)
    params = _params(nsteps=256)
    kw = dict(updraft=updraft, potential=potential, chunk=32,
              min_bucket=64)
    p1, s1 = simulate_presence_sharded_compacting(
        params, starts, jax.random.key(5), **kw)
    p2, s2 = simulate_presence_sharded_compacting(
        params, starts, jax.random.key(5), **kw)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    assert int(s1) == int(s2)


def test_compacting_sharded_small_run_tail_only(rng):
    """A batch at/below min_bucket per shard goes straight to the
    one-dispatch tail and still counts every start."""
    n = 100
    starts = np.stack([rng.integers(3, 6, n), rng.integers(20, 30, n)],
                      axis=1).astype(np.int32)
    presence, steps = simulate_presence_sharded_compacting(
        _params(), starts, jax.random.key(3), min_bucket=64)
    presence = np.asarray(presence)
    assert presence.sum() >= n
    assert presence[GRID[0] // 2:, :].sum() > 0


def test_compacting_sharded_collective_schedule(rng):
    """Collective bound (VERDICT r3 item 2 'Done' criterion): each
    chunk round compiles to exactly ONE all-reduce (the scalar alive
    pmax); the tail/finalize dispatch to exactly two (presence psum +
    steps pmax); no other collective anywhere."""
    from ssrs_tpu.parallel.mesh import (_finalize_sharded_fn,
                                        _round_sharded_fn,
                                        _tail_sharded_fn,
                                        _init_sharded_fn)
    import jax.numpy as jnp
    from ssrs_tpu.agents import prepared_weights
    from ssrs_tpu.agents.simulate import (directional_probs,
                                          restriction_table)

    updraft, potential = _drift_fields()
    params = _params(nsteps=64)
    mesh = make_mesh()
    n = 1024
    starts = np.stack([rng.integers(3, 6, n), rng.integers(20, 30, n)],
                      axis=1).astype(np.int32)
    starts, valid = pad_to_multiple(starts, 8)
    dirp = jnp.asarray(directional_probs(0.))
    table = jnp.asarray(restriction_table())
    base = prepared_weights(jnp.asarray(updraft), jnp.asarray(potential),
                            dirp, params.weight_dtype)
    state = _init_sharded_fn(params, mesh)(
        jnp.asarray(starts), jnp.asarray(valid), jax.random.key(0))
    step0 = jnp.asarray(0, jnp.int32)

    def op_defs(hlo, op):
        return sum(1 for line in hlo.splitlines()
                   if f' {op}(' in line and '=' in line.split(op)[0])

    hlo_round = _round_sharded_fn(params, mesh, 16, True).lower(
        state, step0, base, dirp, table).compile().as_text()
    assert op_defs(hlo_round, 'all-reduce') == 1
    hlo_tail = _tail_sharded_fn(params, mesh, 16, True).lower(
        state, step0, base, dirp, table).compile().as_text()
    assert op_defs(hlo_tail, 'all-reduce') == 2
    hlo_fin = _finalize_sharded_fn(params, mesh).lower(
        state, step0).compile().as_text()
    assert op_defs(hlo_fin, 'all-reduce') == 2
    for hlo in (hlo_round, hlo_tail, hlo_fin):
        for op in ('all-gather', 'all-to-all', 'collective-permute',
                   'reduce-scatter'):
            assert op_defs(hlo, op) == 0, op


def test_collective_schedule_is_one_psum(rng):
    """The entire sharded simulation must compile to exactly two
    all-reduces (presence psum + steps pmax) and no other collective —
    a per-step or per-chunk collective would show up as a count scaling
    with nsteps (scripts/weak_scaling.py asserts the same at 1/2/4/8
    devices)."""
    from ssrs_tpu.parallel import sharded_presence_fn

    nrow, ncol = GRID
    updraft = np.ones(GRID, np.float32)
    potential = (np.linspace(1000., 0., nrow)[:, None]
                 * np.ones((1, ncol))).astype(np.float32)
    n = 512
    starts = np.stack([rng.integers(3, 6, n), rng.integers(20, 30, n)],
                      axis=1).astype(np.int32)
    starts, valid = pad_to_multiple(starts, 8)
    fn = sharded_presence_fn(_params(), make_mesh(), chunk=16)
    hlo = jax.jit(fn).lower(
        jax.numpy.asarray(starts), jax.numpy.asarray(valid),
        jax.random.key(0), jax.numpy.asarray(updraft),
        jax.numpy.asarray(potential)).compile().as_text()

    def op_defs(op):
        return sum(1 for line in hlo.splitlines()
                   if f' {op}(' in line and '=' in line.split(op)[0])

    assert op_defs('all-reduce') == 2
    for op in ('all-gather', 'all-to-all', 'collective-permute',
               'reduce-scatter'):
        assert op_defs(op) == 0, op
