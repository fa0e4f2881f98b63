"""1M-track ensemble stress on the bench workload (500x600 grid): does
the agent engine hold its rate at 10x the north-star population?"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from bench import synthetic_dem
    from ssrs_tpu.agents import (TrackParams, get_starting_indices,
                                 simulate_presence_compacting)
    from ssrs_tpu.fields import (get_above_threshold_speed,
                                 orographic_updraft_from_dem)
    from ssrs_tpu.potential import solve_potential_refined
    from ssrs_tpu.potential.boundary import boundary_masks
    from ssrs_tpu.simulator import _enable_compile_cache

    _enable_compile_cache()
    nrow, ncol, res = 500, 600, 100.0
    n_tracks = 1_000_000
    dem = jnp.asarray(synthetic_dem(nrow, ncol, res))
    w = orographic_updraft_from_dem(
        dem, res, 10. * jnp.ones((nrow, ncol), jnp.float32),
        270. * jnp.ones((nrow, ncol), jnp.float32))
    conductivity = get_above_threshold_speed(w, 0.75)
    bmask, bvals = boundary_masks(0., (nrow, ncol))
    pot, _ = solve_potential_refined(np.asarray(conductivity), bmask,
                                     bvals)
    pot = jnp.asarray(np.asarray(pot))

    rows, cols = get_starting_indices(
        n_tracks, [5., 55., 1., 2.], 'random',
        (ncol * res / 1000., nrow * res / 1000.), res,
        rng=np.random.default_rng(42))
    starts = np.stack([rows, cols], axis=1).astype(np.int32)
    params = TrackParams(grid_shape=(nrow, ncol), move_dirn=0., nu=1.,
                         memory_k=1, burnin=int(min(nrow, ncol) / 10),
                         nsteps=10_000, weight_dtype='bfloat16')

    def run(key):
        return simulate_presence_compacting(
            params, starts, key, updraft=conductivity, potential=pot,
            chunk=512, tail_bucket='auto')  # throughput mode

    jax.block_until_ready(run(jax.random.key(0)))  # compile + first run
    t0 = time.perf_counter()
    presence, steps = jax.block_until_ready(run(jax.random.key(1)))
    dt = time.perf_counter() - t0
    useful = int(np.asarray(presence).astype(np.int64).sum()) - n_tracks
    print(f'1M tracks: {useful} useful steps in {dt:.1f}s = '
          f'{useful/dt/1e6:.1f}M useful steps/s '
          f'(scan steps {int(steps)})', flush=True)


if __name__ == '__main__':
    main()
