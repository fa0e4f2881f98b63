"""Large-scale ensemble smoke benchmark (BASELINE.json config 5):
200x200 km @ 30 m DEM (6667x6667 grid, 44M cells), 100k tracks,
presence accumulation — all on one GPU.

At this size the auto heuristics switch: presence via scatter (one-hot
bandwidth would scale with nrow+ncol=13334), potential via the refined
device solver (lap.py: Galerkin MG + tiled island deflation, 44M
unknowns) — same path as the Simulator's 'auto'."""

import json
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
    from ssrs_tpu.agents import TrackParams, get_starting_indices, \
        simulate_presence_compacting
    from ssrs_tpu.fields import (get_above_threshold_speed,
                                 orographic_updraft_from_dem)
    from ssrs_tpu.potential import solve_potential_refined
    from ssrs_tpu.potential.boundary import boundary_masks

    # 6667^2 = 44.4M cells = the 200x200 km @30 m BASELINE config;
    # first-process multigrid compile is ~3 min (enable the persistent
    # JAX compile cache to amortize)
    nrow = ncol = int(os.environ.get('SSRS_LARGE_N', 6667))
    res = 30.0
    n_tracks = 100_000
    step_cap = int(os.environ.get('SSRS_LARGE_STEPS', 2000))

    dem = jnp.asarray(synthetic_dem(nrow, ncol, res))
    t0 = time.perf_counter()
    w = orographic_updraft_from_dem(
        dem, res, 10. * jnp.ones((nrow, ncol), jnp.float32),
        270. * jnp.ones((nrow, ncol), jnp.float32))
    conductivity = get_above_threshold_speed(w, 0.75)
    conductivity.block_until_ready()
    dt_updraft = time.perf_counter() - t0
    print(f'updraft {dt_updraft:.2f}s', flush=True)

    t0 = time.perf_counter()
    bmask, bvals = boundary_masks(0., (nrow, ncol))
    pot, resid = solve_potential_refined(np.asarray(conductivity), bmask,
                                         bvals, maxcycles=60)
    pot = jax.block_until_ready(pot)
    dt_potential = time.perf_counter() - t0
    print(f'potential {dt_potential:.2f}s resid {float(resid):.4g}',
          flush=True)

    width_km = ncol * res / 1000.
    rows, cols = get_starting_indices(
        n_tracks, [2., width_km - 2., 1., 2.], 'random',
        (width_km, nrow * res / 1000.), res,
        rng=np.random.default_rng(0))
    starts = np.stack([rows, cols], axis=1).astype(np.int32)
    params = TrackParams(grid_shape=(nrow, ncol), move_dirn=0., nu=1.,
                         memory_k=1, burnin=int(min(nrow, ncol) / 10),
                         nsteps=step_cap, weight_dtype='bfloat16')
    t0 = time.perf_counter()
    presence, steps = simulate_presence_compacting(
        params, starts, jax.random.key(0), updraft=conductivity,
        potential=pot, chunk=128, tail_bucket='auto')
    # wait INSIDE the timed window: the 'auto' tail leaves its final
    # dispatch in flight
    presence = jax.block_until_ready(presence)
    dt_sim = time.perf_counter() - t0
    total = int(np.asarray(presence).astype(np.int64).sum())

    print(json.dumps({
        'metric': 'large_scale_smoke',
        'grid': [nrow, ncol],
        'cells': nrow * ncol,
        'updraft_seconds': round(dt_updraft, 2),
        'potential_seconds': round(dt_potential, 2),
        'potential_residual': float(resid),
        'sim_seconds_incl_compile': round(dt_sim, 2),
        'agent_steps': total - n_tracks,
        'steps_taken': int(steps),
    }))


if __name__ == '__main__':
    main()
