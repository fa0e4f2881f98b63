"""Headline benchmark on one GPU: agent-steps per second of the track
engine.

Workload mirrors the reference's main documented benchmark (BASELINE.md):
WY-scale 500x600 grid @100 m, uniform wind, fluidflow movement model —
scaled up to the north-star 100k tracks. The reference simulates 500-1000
tracks on an 8-core laptop pool at roughly 4e4 agent-steps/s total
(500 tracks x ~700 steps in 9 s, workshop/ssrs_demo.ipynb:445); that number
is the ``vs_baseline`` denominator.

Prints ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {..}}
Progress goes to stderr. Every timed region ends in ``block_until_ready``
and runs warm (compiled outside the clock). The script exits non-zero,
with no JSON line, when JAX's default device is not a GPU or any phase
fails.
"""

import json
import sys
import time

import numpy as np

REFERENCE_AGENT_STEPS_PER_SEC = 4.0e4  # derivation above

T0 = time.perf_counter()


def progress(msg):
    print(f'[bench +{time.perf_counter() - T0:7.1f}s] {msg}',
          file=sys.stderr, flush=True)


def synthetic_dem(nrow, ncol, res):
    """Deterministic ridge-and-valley terrain, WY-like relief (~1 km)."""
    y = np.linspace(0, 1, nrow)[:, None]
    x = np.linspace(0, 1, ncol)[None, :]
    z = (500 * np.sin(2 * np.pi * 3.5 * x) * np.cos(2 * np.pi * 2.5 * y)
         + 300 * np.sin(2 * np.pi * 7 * x + 1.3)
         + 200 * np.cos(2 * np.pi * 5 * y + 0.4)
         + 2000)
    return z.astype(np.float32)


def timed(fn, reps=3):
    """Median warm wall seconds of fn() (fn's result is waited on)."""
    import jax
    jax.block_until_ready(fn())
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def main():
    import jax
    import jax.numpy as jnp
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        progress(f'needs an NVIDIA GPU; JAX default device is {dev}')
        return 2
    from ssrs_tpu.simulator import _enable_compile_cache
    _enable_compile_cache()
    from ssrs_tpu.agents import TrackParams, get_starting_indices, \
        prepare_starts, simulate_presence_compacting
    from ssrs_tpu.fields import (get_above_threshold_speed,
                                 orographic_updraft_from_dem)
    from ssrs_tpu.potential import solve_potential_refined
    from ssrs_tpu.potential.boundary import boundary_masks
    progress(f'device {dev} ({dev.device_kind})')

    nrow, ncol, res = 500, 600, 100.0
    n_tracks = 100_000
    step_cap = 10_000

    dem = jnp.asarray(synthetic_dem(nrow, ncol, res))
    speeds = 10. * jnp.ones((nrow, ncol), jnp.float32)

    @jax.jit
    def updraft_for_dirn(dirn):
        w = orographic_updraft_from_dem(dem, res, speeds,
                                        dirn * jnp.ones_like(speeds))
        return get_above_threshold_speed(w, 0.75)

    # --- updraft field throughput (8 wind directions, like seasonal) ---
    sweep = jax.jit(jax.vmap(updraft_for_dirn))
    dirns = jnp.arange(8, dtype=jnp.float32) * 45.
    dt_updraft = timed(lambda: sweep(dirns))
    gridpoints_per_sec = 8 * nrow * ncol / dt_updraft
    progress(f'updraft sweep: {dt_updraft * 1e3:.3f} ms '
             f'({gridpoints_per_sec:.3g} gridpoints/s)')

    conductivity = updraft_for_dirn(270.)

    # --- directional potential: the production refined device solver,
    # including its per-solve host prep ---
    bmask, bvals = boundary_masks(0., (nrow, ncol))
    cond_np = np.asarray(conductivity)
    dt_potential = timed(
        lambda: solve_potential_refined(cond_np, bmask, bvals)[0])
    pot, rrel = solve_potential_refined(cond_np, bmask, bvals)
    if not float(rrel) <= 5e-3:
        raise RuntimeError(f'potential solve did not converge (rrel '
                           f'{float(rrel):.3g})')
    progress(f'potential warm solve: {dt_potential:.3f} s '
             f'(rrel {float(rrel):.3g})')

    # --- track simulation: the headline metric ---
    rows, cols = get_starting_indices(
        n_tracks, [5., 55., 1., 2.], 'random', (ncol * res / 1000.,
                                                nrow * res / 1000.),
        res, rng=np.random.default_rng(42))
    starts = np.stack([rows, cols], axis=1).astype(np.int32)
    params = TrackParams(grid_shape=(nrow, ncol), move_dirn=0., nu=1.,
                         memory_k=1, burnin=int(min(nrow, ncol) / 10),
                         nsteps=step_cap, weight_dtype='bfloat16')
    starts_dev, valid_dev = prepare_starts(starts)

    def run(key):
        return simulate_presence_compacting(
            params, starts_dev, key, updraft=conductivity, potential=pot,
            valid=valid_dev, tail_bucket='auto')

    progress('compiling track engine (one executable per bucket rung)')
    jax.block_until_ready(run(jax.random.key(0)))
    jax.block_until_ready(run(jax.random.key(0)))  # warm tail estimate
    progress('timing 3 warm runs')
    walls, useful, steps_taken = [], [], 0
    for i in range(1, 4):
        t0 = time.perf_counter()
        presence, steps = jax.block_until_ready(run(jax.random.key(i)))
        walls.append(time.perf_counter() - t0)
        useful.append(int(np.asarray(presence).sum(dtype=np.int64))
                      - n_tracks)
        steps_taken = max(steps_taken, int(steps))
    steps_per_sec = sum(useful) / sum(walls)
    print(json.dumps({
        'metric': 'agent_steps_per_sec_per_chip',
        'value': round(steps_per_sec, 1),
        'unit': 'agent-steps/s',
        'vs_baseline': round(steps_per_sec / REFERENCE_AGENT_STEPS_PER_SEC,
                             2),
        'detail': {
            'grid': [nrow, ncol],
            'tracks': n_tracks,
            'agent_steps': sum(useful) // len(useful),
            'timed_runs': len(walls),
            'sim_seconds': round(sum(walls) / len(walls), 4),
            'scan_steps_taken': steps_taken,
            'updraft_gridpoints_per_sec': round(gridpoints_per_sec, 1),
            'potential_solve_seconds': round(dt_potential, 4),
            'device': dev.device_kind,
            'device_count': len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
