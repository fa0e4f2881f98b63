"""END-TO-END direction-sweep benchmark through the production
Simulator path (BASELINE.json config 2 analog): one Simulator,
``simulate_direction_sweep`` over C wind directions x N tracks — DEM ->
updrafts -> thresholds -> batched vmapped potential solves
(_prepare_potentials) -> interleaved multi-case compacting engine ->
presence artifacts. This is the wall a reference user actually pays for
a multi-case study; the component bench (bench_seasonal.py) times the
engine and the prep in isolation.

Prints one JSON line: total wall, per-phase split (fields prep vs
agent engine, from the run's phase timer), and useful agent-steps/s
for the engine phase.

Env: SW_GRID (default 500x600 @100 m), SW_DIRNS (default 8),
SW_TRACKS (default 100000), SW_REPS (default 2: rep 0 warms every
executable; later reps are the quotable warm numbers).

Caveat at large grids: the offline SYNTHETIC terrain at big region
extents (e.g. 1200x1400 @100 m = 140x120 km) produces dense-speckle
conductivity fields that genuinely defeat the device solver on ~1/3
of directions — each such case pays the ~100 s f64 fallback, which is
correct (the flagged solves are off by O(100)/1000 vs the f64 oracle)
but dominates the wall. See docs/DESIGN.md "the large-region
synthetic-terrain stall class". The measured Appalachian captures use
50 m resolution (70x60 km region at this grid), which does not stall.
"""

import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main():
    from ssrs_tpu.simulator import Simulator, _enable_compile_cache

    _enable_compile_cache()
    grid = os.environ.get('SW_GRID', '500x600')
    nrow, ncol = (int(v) for v in grid.split('x'))
    n_dirns = int(os.environ.get('SW_DIRNS', 8))
    n_tracks = int(os.environ.get('SW_TRACKS', 100_000))
    reps = int(os.environ.get('SW_REPS', 2))
    dirns = [float(d) for d in np.linspace(180., 320., n_dirns)]

    out_dir = '/tmp/sweep_e2e_out'
    shutil.rmtree(out_dir, ignore_errors=True)
    sim = Simulator(
        run_name='sweep', out_dir=out_dir, sim_mode='uniform',
        sim_seed=1, southwest_lonlat=(-106.21, 42.78),
        region_width_km=(ncol * 0.1, nrow * 0.1), resolution=100.,
        uniform_winddirn=270., uniform_windspeed=10.,
        track_direction=0., track_count=n_tracks,
        track_start_region=(1., ncol * 0.1 - 1., 1., 2.),
        movement_model='fluidflow')

    results = []
    for rep in range(reps):
        # fresh artifacts each rep: the sweep must re-solve every case
        shutil.rmtree(sim.mode_data_dir, ignore_errors=True)
        os.makedirs(sim.mode_data_dir, exist_ok=True)
        sim.timer.records.clear()
        t0 = time.perf_counter()
        cases = sim.simulate_direction_sweep(dirns)
        wall = time.perf_counter() - t0
        assert len(cases) == n_dirns
        steps = 0
        engine_wall = 0.
        for rec in sim.timer.records:
            if rec.get('phase') == 'batched_tracks':
                steps += int(rec.get('useful_steps', 0))
                engine_wall += float(rec.get('seconds', 0.))
        results.append((wall, steps, engine_wall))
        print(f'rep {rep}: wall={wall:.2f}s (engine {engine_wall:.2f}s, '
              f'prep {wall - engine_wall:.2f}s) useful_steps={steps}',
              flush=True)

    wall, steps, engine_wall = min(results, key=lambda r: r[0])
    out = {
        'bench': 'sweep_e2e',
        'grid': f'{nrow}x{ncol}',
        'cases': n_dirns,
        'tracks_per_case': n_tracks,
        'wall_s': round(wall, 2),
        # phase split from the run's timer: 'batched_tracks' is the
        # agent-engine wall; everything else (updrafts, thresholds,
        # batched potential solves, artifact IO) is prep
        'engine_wall_s': round(engine_wall, 2),
        'prep_wall_s': round(wall - engine_wall, 2),
        'useful_steps': steps,
        'steps_per_s_e2e': round(steps / wall) if steps else None,
        'steps_per_s_engine': (round(steps / engine_wall)
                               if steps and engine_wall else None),
    }
    print(json.dumps(out))


if __name__ == '__main__':
    main()
