"""Whether the last study of a run is correct: what it produced, compared
with the plain float64 references of ``reference.py``.

Each stage is compared on the inputs the program itself used (its DEM,
the conductivity its solver was given, its potential, its counts), so an
error is charged to the stage that made it:

- ``updraft``       max |orograph - f64 orograph from the DEM|, m/s
- ``potential``     max |potential - f64 SuperLU potential| / 1000
- ``weights``       max relative error of the engine's move-weight table
                    against the f64 table (inf where a zero disagrees)
- ``presence_l1``   L1 distance of the normalized smoothed presence map
                    to that of the f64 reference walk
- ``moves_rel``     relative gap of the mean moves per track to the
                    reference walk's
- ``start_deficit`` cells whose count is below the number of tracks that
                    started there (exact: every start is a visit)
- ``summary``       max |summary presence map - f64 summary of the
                    program's counts|

Which cases are compared, and the reference walk's starts and moves, are
drawn from the run's seed. ``control=True`` puts one precision step below
the stated one in the program's place: the reference in bfloat16 for the
fields and the presence smoothing, the reference solve in float32, and
the program's own bfloat16 weight table (the caller runs the study with
it).
"""

from __future__ import annotations

import os

import numpy as np

from . import reference as R
from .harness import derive_seed


def _max_abs(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        return float('inf')
    return float(np.abs(a - b).max())


def _table_rel(got, want):
    got = np.asarray(got, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float('inf')
    zero = want == 0
    if np.any(got[zero] != 0):
        return float('inf')
    return float((np.abs(got[~zero] - want[~zero])
                  / np.abs(want[~zero])).max())


def _normalized(x):
    x = np.asarray(x, np.float64)
    return x / x.sum()


def kernel_radius(sim, radius=1000.):
    """The presence-map kernel radius in cells: radius / resolution,
    clamped to [2, min(grid) / 2]."""
    return int(round(min(max(radius / sim.resolution, 2),
                         min(sim.gridsize) / 2)))


def study_starts(sim, seed, n_studies):
    """The start cells of the last of ``n_studies`` studies: each study
    draws its starts once from the Simulator's generator, seeded at
    construction (``harness.simulator_config``)."""
    rng = np.random.default_rng(derive_seed(seed, 'starts'))
    for _ in range(n_studies):
        rows, cols = R.starting_cells(
            int(sim.track_count), list(sim.track_start_region),
            tuple(sim.region_width_km), float(sim.resolution), rng)
    return rows, cols


def check_study(sim, wl, captures, summary, n_studies, seed,
                control=False):
    """The compared numbers of the study that just ran, by name."""
    chk = wl['check']
    rng = np.random.default_rng(derive_seed(seed, 'check'))
    cases = list(sim.case_ids)
    if wl['study'] == 'sweep':
        dirns = [float(d) for d in wl['directions']]
    else:
        dirns = [float(sim.uniform_winddirn)]
    n = len(cases)
    data = sim.mode_data_dir
    move_dirn = float(sim.track_direction)
    nrow, ncol = sim.gridsize

    def artifact(case, kind):
        if kind == 'orograph':
            return np.load(os.path.join(data, f'{case}_orograph.npy'))
        sid = sim._get_id_string(case, 0)
        return np.load(os.path.join(data, f'{sid}_{kind}.npy'))

    def sample(k):
        return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())

    out = {}
    # fields: f64 slope/aspect of the DEM the study read
    dem = np.asarray(sim.get_terrain_elevation(), np.float64)
    res = float(sim.resolution)
    speed = float(sim.uniform_windspeed)
    slope, aspect = R.slope_aspect(dem, res)
    if control:
        slope_lo, aspect_lo = R.slope_aspect(dem, res, lower=True)
    err = 0.
    for i in sample(chk['updraft_cases']):
        want = R.orographic_updraft(speed, dirns[i], slope, aspect)
        got = R.orographic_updraft(speed, dirns[i], slope_lo, aspect_lo,
                                   lower=True) \
            if control else artifact(cases[i], 'orograph')
        err = max(err, _max_abs(got, want))
    out['updraft'] = err

    if float(sim.track_stochastic_nu) != 1. or \
            int(sim.track_dirn_restrict) != 1:
        raise ValueError('the reference walk implements nu = 1 and a '
                         'one-move direction memory')
    conds = captures.conductivity
    # (capture, index in it) of each case's table, pulled to the host
    # only for the sampled cases
    where = [(t, j) for t in captures.tables for j in range(t.shape[0])]
    seen = len(conds) == n and len(where) == n
    pot_err = w_err = float('inf') if not seen else 0.
    if seen:
        prior = R.directional_prior(move_dirn)
        for i in sample(chk['potential_cases']):
            cond = np.asarray(conds[i], np.float64)
            want = R.solve_potential(cond, move_dirn)
            got = R.solve_potential(cond, move_dirn, lower=True) \
                if control else artifact(cases[i], 'potential')
            pot_err = max(pot_err, _max_abs(got, want) / 1000.)
        for i in sample(chk['weights_cases']):
            cond = np.asarray(conds[i], np.float64)
            want = R.weight_table(cond, artifact(cases[i], 'potential'),
                                  prior)
            t, j = where[i]
            w_err = max(w_err, _table_rel(np.asarray(t[j]), want))
    out['potential'] = pot_err
    out['weights'] = w_err

    # the walk: the program's counts against the reference walk over
    # the program's conductivity and potential
    krad = kernel_radius(sim)
    n_tracks = int(sim.track_count)
    cap = int(np.ceil(nrow / 2 * ncol / 2))
    l1 = mrel = float('inf') if not seen else 0.
    if seen:
        walk_rng = np.random.default_rng(derive_seed(seed, 'walk'))
        for i in sample(chk['presence_cases']):
            counts = artifact(cases[i], 'counts')
            rows, cols = R.starting_cells(
                int(chk['reference_tracks']), list(sim.track_start_region),
                tuple(sim.region_width_km), float(sim.resolution), walk_rng)
            ref, moves = R.walk_tracks(
                np.asarray(conds[i], np.float64),
                artifact(cases[i], 'potential'), move_dirn,
                np.stack([rows, cols], axis=1), cap, walk_rng)
            a = _normalized(R.smooth(counts, krad))
            b = _normalized(R.smooth(ref, krad))
            l1 = max(l1, float(np.abs(a - b).sum()))
            got = (counts.sum(dtype=np.int64) - n_tracks) / n_tracks
            want = moves / int(chk['reference_tracks'])
            mrel = max(mrel, abs(got - want) / want)
    out['presence_l1'] = l1
    out['moves_rel'] = mrel

    rows, cols = study_starts(sim, seed, n_studies)
    starts = np.bincount(rows * ncol + cols,
                         minlength=nrow * ncol).reshape(nrow, ncol)
    all_counts = [artifact(c, 'counts') for c in cases]
    out['start_deficit'] = float(sum(int(np.sum(c < starts))
                                     for c in all_counts))

    want = R.summary_presence(all_counts, krad)
    got = R.summary_presence(all_counts, krad, lower=True) if control \
        else summary
    out['summary'] = _max_abs(got, want)
    return out


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): each number at or under its
    limit."""
    rows = [(name, float(numbers[name]), float(limits[name]['limit']))
            for name in limits]
    return all(v <= lim for _, v, lim in rows), rows
