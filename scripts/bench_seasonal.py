"""Seasonal-ensemble benchmark (BASELINE.json config 4 analog, offline):
many wind-field cases x 1000 tracks on an Appalachian-scale grid
(1200x1400 @50 m), A/B-ing the two multi-case engines:

- 'vmapped': the jitted lockstep engine (simulate_presence_cases) —
  XLA step, no compaction, all cases run until the last one dies;
- 'compacting': the production path
  (simulate_presence_cases_compacting) — per-case dead-agent
  compaction + one-dispatch tail, host scalar reads overlapped across
  cases.

Potential fields go through the production refined solver. The
potential prep itself is A/B'd — per-case sequential refined solves vs
the batched vmapped solver (groups of SSRS_SEASONAL_BATCH, default 8).
Each mode runs twice; the warm rep is the quotable number. Every timed
region ends in block_until_ready. No GPU timing of this script has been
recorded yet. ``fields_seconds`` is the
end-to-end prep wall with the best prep mode (updrafts + potentials +
weight tables)."""

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
    from ssrs_tpu.agents import (TrackParams, directional_probs,
                                 get_starting_indices, prepared_weights,
                                 simulate_presence_cases,
                                 simulate_presence_cases_compacting)
    from ssrs_tpu.fields import (get_above_threshold_speed,
                                 orographic_updraft_from_dem)
    from ssrs_tpu.potential import solve_potential_refined
    from ssrs_tpu.potential.boundary import boundary_masks

    # defaults: the Appalachian-scale workload; the WY-scale seasonal
    # run is SSRS_SEASONAL_GRID=500x600 SSRS_SEASONAL_TRACKS=100000
    grid_env = os.environ.get('SSRS_SEASONAL_GRID', '1200x1400')
    nrow, ncol = (int(v) for v in grid_env.split('x'))
    res = 50.0
    n_cases = int(os.environ.get('SSRS_SEASONAL_CASES', 24))
    n_tracks = int(os.environ.get('SSRS_SEASONAL_TRACKS', 1000))
    step_cap = int(os.environ.get('SSRS_SEASONAL_CAP', 4000))

    dem = jnp.asarray(synthetic_dem(nrow, ncol, res))
    dirp = jnp.asarray(directional_probs(0.))
    params = TrackParams(grid_shape=(nrow, ncol), move_dirn=0., nu=1.,
                         memory_k=1, burnin=int(min(nrow, ncol) / 10),
                         nsteps=step_cap)

    # one wind case per sampled direction/speed (the seasonal analog)
    rng = np.random.default_rng(1)
    dirns = rng.uniform(180., 360., n_cases).astype(np.float32)
    speeds = rng.uniform(6., 14., n_cases).astype(np.float32)

    # all C updrafts+thresholds in ONE dispatch. Run twice: the first
    # call carries the one-time compile (persistent-cached).
    @jax.jit
    def batched_conds(speeds, dirns):
        ones = jnp.ones((nrow, ncol), jnp.float32)
        return jax.vmap(lambda s, d: get_above_threshold_speed(
            orographic_updraft_from_dem(dem, res, s * ones, d * ones),
            0.75))(speeds, dirns)

    jax.block_until_ready(batched_conds(jnp.asarray(speeds),
                                        jnp.asarray(dirns)))
    t_up = time.perf_counter()
    conds = batched_conds(jnp.asarray(speeds), jnp.asarray(dirns))
    bmask, bvals = boundary_masks(0., (nrow, ncol))
    conds_np = list(np.asarray(conds))  # host copy for the host labeling
    conds = list(conds)
    dt_updrafts = time.perf_counter() - t_up

    # potential-prep A/B: per-case sequential refined solves vs the
    # batched vmapped solver (Config.potential_batch > 1). Each mode
    # runs twice: run 0 carries the one-time compiles, run 1 is the
    # quotable warm number.
    from ssrs_tpu.potential import solve_potential_refined_batch
    prep_mode = os.environ.get('SSRS_SEASONAL_PREP', 'both')
    group = int(os.environ.get('SSRS_SEASONAL_BATCH', 8))
    prep = {}

    def run_sequential():
        pots = [solve_potential_refined(c, bmask, bvals)[0]
                for c in conds_np]
        return [np.asarray(p) for p in jax.block_until_ready(pots)]

    def run_batched():
        pots = []
        for i0 in range(0, n_cases, group):
            p, _ = solve_potential_refined_batch(conds_np[i0:i0 + group],
                                                 bmask, bvals)
            pots.append(p)
        return [np.asarray(p) for chunk in pots for p in chunk]

    runners = {'sequential': run_sequential, 'batched': run_batched}
    if prep_mode != 'both':
        runners = {prep_mode: runners[prep_mode]}
    pots = None
    for name, runner in runners.items():
        walls = []
        for rep in range(2):
            t0 = time.perf_counter()
            pots = runner()
            walls.append(round(time.perf_counter() - t0, 2))
            print(f'prep[{name}] rep {rep}: {walls[-1]}s', flush=True)
        prep[name] = {'cold_s': walls[0], 'warm_s': walls[1]}

    from ssrs_tpu.agents import prepared_weights_batch

    def build_tables():
        t = prepared_weights_batch(
            jnp.stack(conds), jnp.asarray(np.stack(pots)),
            jnp.broadcast_to(dirp, (n_cases, 9)), 'bfloat16')
        return jax.block_until_ready(t)

    build_tables()  # one-time compile (persistent-cached)
    t0 = time.perf_counter()
    tables = build_tables()
    dt_tables = time.perf_counter() - t0
    dt_fields = (dt_updrafts + dt_tables
                 + prep[min(prep,
                            key=lambda k: prep[k]['warm_s'])]['warm_s'])

    rows, cols = get_starting_indices(
        n_tracks, [2., ncol * res / 1000. - 2., 1., 2.], 'random',
        (ncol * res / 1000., nrow * res / 1000.), res,
        rng=np.random.default_rng(2))
    starts = jnp.asarray(np.stack([rows, cols], 1), jnp.int32)
    keys = jax.random.split(jax.random.key(0), n_cases)
    dirps = jnp.broadcast_to(dirp, (n_cases, 9))

    def run_vmapped(seed):
        ks = jax.random.split(jax.random.key(seed), n_cases)
        p, s = simulate_presence_cases(params, tables, dirps, starts,
                                       ks, chunk=512)
        return np.asarray(jax.block_until_ready(p))

    def run_compacting(seed):
        ks = list(jax.random.split(jax.random.key(seed), n_cases))
        p, s = simulate_presence_cases_compacting(
            params, list(tables), starts, ks, dirps=dirps, chunk=512,
            tail_bucket='auto')
        return np.asarray(jax.block_until_ready(p))

    results = {}
    for name, runner in (('vmapped', run_vmapped),
                         ('compacting', run_compacting)):
        runner(0)  # compile + first run
        runner(0)  # warm caches / auto-tail estimates
        t0 = time.perf_counter()
        p = runner(1)
        dt = time.perf_counter() - t0
        total = int(p.astype(np.int64).sum())
        results[name] = {
            'sim_seconds': round(dt, 2),
            'agent_steps': total - n_cases * n_tracks,
            'steps_per_sec': round((total - n_cases * n_tracks) / dt, 1),
        }

    print(json.dumps({
        'metric': 'seasonal_ensemble',
        'grid': [nrow, ncol],
        'cases': n_cases,
        'tracks_per_case': n_tracks,
        'fields_seconds': round(dt_fields, 2),
        'updraft_seconds': round(dt_updrafts, 2),
        'tables_seconds': round(dt_tables, 2),
        'potential_prep': prep,
        'engines': results,
        'speedup_compacting_vs_vmapped': round(
            results['vmapped']['sim_seconds']
            / max(results['compacting']['sim_seconds'], 1e-9), 2),
    }))


if __name__ == '__main__':
    main()
