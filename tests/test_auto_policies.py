"""The engine's 'auto' policies and option validation: weight-table
precision, presence accumulation and step engine."""

import jax.numpy as jnp
import numpy as np
import pytest

from ssrs_tpu.agents.simulate import (TrackParams, prepared_weights,
                                      resolve_presence_impl,
                                      resolve_step_impl,
                                      resolve_weight_dtype,
                                      simulate_presence)
from ssrs_tpu.agents.moves import directional_probs


def _p(**kw):
    return TrackParams(grid_shape=(50, 60), move_dirn=0., nu=1.,
                       memory_k=1, burnin=5, nsteps=100, **kw)


def test_presence_matmul_area_policy():
    """presence 'auto' is the scatter-add at every grid area (the GPU
    timing in PERF.md found no area where the one-hot matmul wins);
    explicit choices pass through."""
    assert resolve_presence_impl('auto') == 'scatter'
    for impl in ('matmul', 'scatter', 'none'):
        assert resolve_presence_impl(impl) == impl


@pytest.mark.parametrize('presence', ['auto', 'matmul'])
def test_presence_paths_bit_identical(rng, presence):
    """'auto' runs the scatter program, and the one-hot matmul gives
    bit-identical counts: the sampled moves do not depend on how presence
    is accumulated, and integer sums do not depend on their order."""
    import jax
    grid = (40, 48)
    up = (0.5 + rng.random(grid)).astype(np.float32)
    pot = (np.linspace(1000., 0., grid[0])[:, None]
           * np.ones((1, grid[1]), np.float32))
    starts = np.stack([rng.integers(3, 8, 500), rng.integers(10, 38, 500)],
                      axis=1).astype(np.int32)
    out = [np.asarray(simulate_presence(_p(presence_impl=impl)._replace(
        grid_shape=grid, burnin=4), starts, jax.random.key(1),
        updraft=jnp.asarray(up), potential=jnp.asarray(pot), chunk=32)[0])
        for impl in (presence, 'scatter')]
    np.testing.assert_array_equal(out[0], out[1])


def test_step_impl_typo_raises():
    """A step_impl typo must raise, not silently downgrade to XLA."""
    with pytest.raises(ValueError, match='fuesd'):
        resolve_step_impl(_p(step_impl='fuesd'))


@pytest.mark.parametrize('impl', ['fused', 'fused-interpret'])
def test_removed_fused_step_raises(impl):
    """The fused step kernel is gone: asking for it raises a
    ValueError that says so, from the resolver and from the step
    builder the drivers call."""
    from ssrs_tpu.agents.simulate import make_step_fn
    with pytest.raises(ValueError, match='removed'):
        resolve_step_impl(_p(step_impl=impl))
    with pytest.raises(ValueError, match='removed'):
        make_step_fn(_p(step_impl=impl), None,
                     jnp.asarray(directional_probs(0.)),
                     jnp.ones((9, 9), jnp.float32))


@pytest.mark.parametrize('impl', ['auto', 'xla'])
def test_step_impl_resolves_to_xla(impl):
    assert resolve_step_impl(_p(step_impl=impl)) == 'xla'


def test_steps_counter_saturates_at_cap(rng):
    """The reported steps_taken must not overshoot params.nsteps even
    though the chunked drivers run whole chunks (the counter used to
    free-run to the next chunk boundary)."""
    nrow, ncol = 40, 48
    params = TrackParams(grid_shape=(nrow, ncol), move_dirn=0., nu=1.,
                         memory_k=1, burnin=4, nsteps=100,
                         step_impl='xla')
    updraft = jnp.asarray(rng.random((nrow, ncol), np.float32) + 0.5)
    potential = jnp.asarray(np.linspace(1000., 0., nrow)[:, None]
                            * np.ones((1, ncol), np.float32))
    starts = np.stack([np.full(64, nrow // 2), np.full(64, ncol // 2)],
                      axis=1).astype(np.int32)
    import jax
    _, steps = simulate_presence(params, starts, jax.random.key(0),
                                 updraft=updraft, potential=potential,
                                 chunk=64)
    assert int(steps) <= params.nsteps


def test_resolve_weight_dtype_policy():
    # explicit tiers pass through; auto is the reference's float32 at
    # every grid (the bf16 table was not faster in the GPU step, PERF.md)
    assert resolve_weight_dtype('float32') == 'float32'
    assert resolve_weight_dtype('bfloat16') == 'bfloat16'
    assert resolve_weight_dtype('auto') == 'float32'


def test_prepared_weights_auto_resolves_by_grid(rng):
    dirp = jnp.asarray(directional_probs(0.))
    small = jnp.asarray(rng.random((40, 50), dtype=np.float32))
    pot = jnp.zeros((40, 50), jnp.float32)
    assert prepared_weights(small, pot, dirp, 'auto').dtype == jnp.float32
    big = jnp.asarray(rng.random((500, 600), dtype=np.float32))
    potb = jnp.zeros((500, 600), jnp.float32)
    assert prepared_weights(big, potb, dirp, 'auto').dtype == jnp.float32
    assert prepared_weights(big, potb, dirp,
                            'bfloat16').dtype == jnp.bfloat16


def test_prepared_weights_batch_matches_per_case(rng):
    """One-dispatch multi-case table build == per-case builds."""
    from ssrs_tpu.agents import prepared_weights_batch
    grid = (30, 40)
    ups = np.stack([(0.5 + rng.random(grid)).astype(np.float32)
                    for _ in range(3)])
    pots = np.stack([(np.linspace(100. * (i + 1), 0., grid[0])[:, None]
                      * np.ones((1, grid[1]), np.float32))
                     for i in range(3)])
    dirps = np.stack([directional_probs(d) for d in (0., 90., 215.)])
    batch = prepared_weights_batch(jnp.asarray(ups), jnp.asarray(pots),
                                   jnp.asarray(dirps), 'float32')
    for i in range(3):
        one = prepared_weights(jnp.asarray(ups[i]), jnp.asarray(pots[i]),
                               jnp.asarray(dirps[i]), 'float32')
        np.testing.assert_array_equal(np.asarray(batch[i]),
                                      np.asarray(one))
