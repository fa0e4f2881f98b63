"""Bring-up check of ssrs_tpu on an NVIDIA GPU.

Drives the Simulator main path at the README's WY study size (500x600 grid
at 100 m, 100 000 tracks, uniform 270 deg wind, offline synthetic DEM), then
an 8-direction sweep on the same grid, and compares each device computation
on that path with the repository's plain references (float64 NumPy oracles,
the host float64 SuperLU solve, the sequential agent oracle).

    python chip_smoke.py                # one GPU: phases 0-4
    python chip_smoke.py --four-cards   # four GPUs: the multi-device paths

Phases (one GPU):
  0  the device: refuse anything but a GPU; print the card and versions;
  1  numerics against the plain references at real widths;
  2  the main path through ``Simulator``;
  3  bring-up timings behind the step's two 'auto' policies, and a short
     profiler trace of the XLA step (written under chip_smoke_out/);
  4  the card-only tests (``pytest -m gpu``), in this same process.

Every phase runs even after an earlier one failed; the script then exits
non-zero and prints no result line. On success the last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Only this process uses the card(s).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, 'chip_smoke_out')

# the main path's study: the README's WY example at its headline size
WY_SHAPE = (500, 600)
WY_TRACKS = 100_000
SWEEP_DIRNS = [0., 45., 90., 135., 180., 225., 270., 315.]

# tolerances, each the one the CPU test suite uses for the same check
TOL_SLOPE = dict(rtol=2e-5, atol=1e-4)       # tests/test_fields.py
TOL_ASPECT = dict(rtol=3e-4, atol=5e-2)      # tests/test_fields.py
TOL_UPDRAFT = dict(rtol=1e-5, atol=1e-6)     # tests/test_fields.py
ASPECT_MIN_SLOPE = 0.1  # deg; flatter cells have no well-defined aspect
TOL_WEIGHTS = dict(rtol=1e-6, atol=0.)
TOL_SOLVE_ABS = 1.0     # max |device - f64| on the 0-1000 potential scale
TOL_SOLVE_RREL = 1e-5   # tests/test_potential.py (at-scale solve)
TOL_PRESENCE_L1 = 0.08  # smoothed-presence L1, tests/test_agents.py
# relative error of a DS product: a few units of 2^-48 (the DS unit
# roundoff) — 2^-44 leaves a 16x margin
TOL_DS_MUL = 2.0 ** -44


def log(msg: str = '') -> None:
    print(msg, flush=True)


class Checks:
    """Prints each check beside its limit and remembers the failures."""

    def __init__(self):
        self.failed = []

    def check(self, name: str, value: float, limit: float) -> bool:
        ok = bool(value <= limit)
        log(f'  [{"PASS" if ok else "FAIL"}] {name}: {value:.6g} '
            f'(limit {limit:.6g})')
        if not ok:
            self.failed.append(name)
        return ok

    def require(self, name: str, ok: bool, detail: str = '') -> bool:
        log(f'  [{"PASS" if ok else "FAIL"}] {name}'
            + (f': {detail}' if detail else ''))
        if not ok:
            self.failed.append(name)
        return bool(ok)


# ---- reference data ------------------------------------------------------

def ridge_dem(shape, res: float = 100.) -> np.ndarray:
    """Deterministic terrain-like DEM (ridges + bumps, ~1 km relief): the
    test suite's fixture (tests/conftest.py) stretched to ``shape``."""
    ny, nx = shape
    y = np.linspace(0, 4 * np.pi, ny)[:, None]
    x = np.linspace(0, 5 * np.pi, nx)[None, :]
    z = (400 * np.sin(0.7 * x) * np.cos(0.9 * y)
         + 150 * np.sin(2.3 * x + 0.5) + 100 * np.cos(1.7 * y) + 1500)
    return z.astype(np.float64)


def wy_conductivity(shape, res: float = 100., dirn: float = 270.):
    """Thresholded orographic updraft (10 m/s wind from ``dirn``) over
    :func:`ridge_dem`, float32 on the host."""
    import jax.numpy as jnp
    from ssrs_tpu.fields import (get_above_threshold_speed,
                                 orographic_updraft_from_dem)
    dem = ridge_dem(shape, res)
    w = orographic_updraft_from_dem(
        jnp.asarray(dem, jnp.float32), res, jnp.float32(10.),
        jnp.float32(dirn))
    return np.asarray(get_above_threshold_speed(w, 0.75), np.float32)


def weights_table_f64(updraft, potential, dirp) -> np.ndarray:
    """Float64 NumPy move-weight table: harmonic-mean updraft x potential
    drop / step length, clipped at 0, centre 0, NaN rows (border) replaced
    by the directional prior (ssrs/movmodel.py:227-232, 294-305)."""
    from ssrs_tpu.agents.moves import (CENTER_ZERO, NEIGHBOR_DELTAS,
                                       NEIGHBOR_NORMS_INV)
    w = np.clip(np.asarray(updraft, np.float64), 1e-6, None)
    p = np.asarray(potential, np.float64)
    nrow, ncol = w.shape
    wpad = np.pad(w, 1, constant_values=1e-6)
    ppad = np.pad(p, 1, constant_values=np.nan)
    out = np.empty((nrow, ncol, 9))
    for m in range(9):
        dr, dc = (int(v) for v in NEIGHBOR_DELTAS[m])
        wn = wpad[1 + dr:1 + dr + nrow, 1 + dc:1 + dc + ncol]
        pn = ppad[1 + dr:1 + dr + nrow, 1 + dc:1 + dc + ncol]
        out[..., m] = (2. / (1. / w + 1. / wn) * (p - pn)
                       * float(NEIGHBOR_NORMS_INV[m]))
    c0 = np.asarray(CENTER_ZERO, np.float64)
    with np.errstate(invalid='ignore'):
        out = np.clip(out, 0., None) * c0
    nan_row = np.isnan(out).any(axis=-1, keepdims=True)
    out = np.where(nan_row, np.asarray(dirp, np.float64) * c0, out)
    return out.reshape(-1, 9)


def _normalized_excess(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|): <= 1 is the
    ``np.testing.assert_allclose`` criterion."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    scale = atol + rtol * np.abs(want)
    with np.errstate(divide='ignore', invalid='ignore'):
        ratio = np.where(err == 0., 0., err / scale)
    return float(np.max(ratio))


# ---- phase 1: numerics ---------------------------------------------------

def _random_f32(rng, n, emin, emax):
    """Random float32 values sign * [1, 2) * 2^e, e uniform in
    [emin, emax]: every binade of that range equally often."""
    mant = rng.uniform(1., 2., n)
    exp = rng.integers(emin, emax + 1, n)
    sign = rng.choice([-1., 1.], n)
    return (sign * np.ldexp(mant, exp)).astype(np.float32)


def check_ds(checks: Checks, n: int = 1_000_000, seed: int = 0) -> None:
    """Error-free transforms on the device against float64. ``two_sum``
    and ``two_prod`` must be exact: hi + lo == the float64 result, since
    both sides are then the float64 rounding of one real number.
    Exponents stay inside the range where every partial product and
    error term is a normal float32 (no underflow, no overflow)."""
    import jax
    import jax.numpy as jnp
    from ssrs_tpu.potential.ds import DS, ds_mul_f32, two_prod, two_sum

    rng = np.random.default_rng(seed)
    a = _random_f32(rng, n, -100, 100)
    b = _random_f32(rng, n, -100, 100)
    s, e = jax.jit(two_sum)(jnp.asarray(a), jnp.asarray(b))
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    want = a.astype(np.float64) + b.astype(np.float64)
    checks.check('two_sum: pairs where hi + lo != a + b (f64), exponents '
                 '[-100, 100]', int(np.sum(got != want)), 0)

    a = _random_f32(rng, n, -30, 30)
    b = _random_f32(rng, n, -30, 30)
    p, e = jax.jit(two_prod)(jnp.asarray(a), jnp.asarray(b))
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    want = a.astype(np.float64) * b.astype(np.float64)
    checks.check('two_prod: pairs where hi + lo != a * b (f64), exponents '
                 '[-30, 30]', int(np.sum(got != want)), 0)

    x64 = (rng.uniform(-1., 1., n)
           * np.ldexp(1., rng.integers(-30, 31, n)))
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    w = _random_f32(rng, n, -30, 30)
    r = jax.jit(lambda h, l, w: ds_mul_f32(DS(h, l), w))(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(w))
    got = np.asarray(r.hi, np.float64) + np.asarray(r.lo, np.float64)
    want = (hi.astype(np.float64) + lo.astype(np.float64)) \
        * w.astype(np.float64)
    rel = np.abs(got - want) / np.abs(want)
    checks.check('ds_mul_f32: max relative error vs f64', float(rel.max()),
                 TOL_DS_MUL)


def check_terrain(checks: Checks, shape=WY_SHAPE, res: float = 100.):
    """Slope, aspect and orographic updraft (float32 device kernels)
    against the float64 oracles of tests/oracles.py."""
    from ssrs_tpu.fields import (compute_aspect_degrees,
                                 compute_orographic_updraft,
                                 compute_slope_degrees)
    from oracles import orographic_oracle, slope_aspect_oracle
    # the kernels compute in float32 from a float32 DEM: the oracle gets
    # the same DEM values, so the comparison isolates the kernels'
    # arithmetic from the rounding of their input
    dem = ridge_dem(shape, res).astype(np.float32)
    want_s, want_a = slope_aspect_oracle(dem.astype(np.float64), res)
    got_s = np.asarray(compute_slope_degrees(dem, res))
    got_a = np.asarray(compute_aspect_degrees(dem, res))
    checks.check(f'slope {shape}: max |err| / (atol + rtol|ref|) '
                 f'{TOL_SLOPE}', _normalized_excess(got_s, want_s,
                                                     **TOL_SLOPE), 1.)
    # aspect is an angle: 0 and 360 deg are the same direction, and the
    # reference formula wraps between them where the x-gradient changes
    # sign, so compare the got value unwrapped onto the reference's side.
    # On near-flat cells the direction of a vanishing gradient is set by
    # float32 rounding (its sensitivity grows as 1/slope): those cells
    # are counted and left out.
    d = (got_a.astype(np.float64) - want_a + 180.) % 360. - 180.
    steep = want_s >= ASPECT_MIN_SLOPE
    checks.check(f'aspect {shape} (angular difference, {int((~steep).sum())}'
                 f' cells under {ASPECT_MIN_SLOPE} deg slope left out): max '
                 f'|err| / (atol + rtol|ref|) {TOL_ASPECT}',
                 _normalized_excess((want_a + d)[steep], want_a[steep],
                                    **TOL_ASPECT), 1.)
    # the kernel's own inputs are float32: the oracle gets the same values
    s32, a32 = want_s.astype(np.float32), want_a.astype(np.float32)
    got_w = np.asarray(compute_orographic_updraft(10., 270., s32, a32))
    want_w = orographic_oracle(10., 270., s32.astype(np.float64),
                               a32.astype(np.float64))
    checks.check(f'orographic updraft {shape}: max |err| / (atol + '
                 f'rtol|ref|) {TOL_UPDRAFT}',
                 _normalized_excess(got_w, want_w, **TOL_UPDRAFT), 1.)


def check_weights(checks: Checks, cond, potential) -> None:
    """``prepared_weights`` (float32 table) against the float64 NumPy
    harmonic-mean table."""
    import jax.numpy as jnp
    from ssrs_tpu.agents import directional_probs, prepared_weights
    dirp = directional_probs(0.)
    got = np.asarray(prepared_weights(jnp.asarray(cond),
                                      jnp.asarray(potential),
                                      jnp.asarray(dirp), 'float32'))
    want = weights_table_f64(cond, potential, dirp)
    checks.check(f'prepared_weights {cond.shape}: max |err| / (rtol|ref|) '
                 f'{TOL_WEIGHTS}', _normalized_excess(got, want,
                                                       **TOL_WEIGHTS), 1.)


def check_solve(checks: Checks, cond, dirn: float = 0.):
    """Refined device solve against the host float64 SuperLU solve;
    returns the device potential (host float32)."""
    from ssrs_tpu.potential import (boundary_masks, solve_potential_direct,
                                    solve_potential_refined)
    bmask, bvals = boundary_masks(dirn, cond.shape)
    t0 = time.perf_counter()
    pot, rrel = solve_potential_refined(cond, bmask, bvals)
    pot = np.asarray(pot)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = solve_potential_direct(cond, dirn).astype(np.float64)
    t_host = time.perf_counter() - t0
    log(f'  refined solve {cond.shape}: {t_dev:.3f} s incl. compile; '
        f'host SuperLU {t_host:.3f} s')
    checks.check(f'refined solve {cond.shape}: max |device - f64 SuperLU| '
                 '(0-1000 scale)',
                 float(np.abs(pot.astype(np.float64) - want).max()),
                 TOL_SOLVE_ABS)
    checks.check(f'refined solve {cond.shape}: relative residual',
                 float(rrel), TOL_SOLVE_RREL)
    return pot


def check_presence_paths(checks: Checks, shape=WY_SHAPE,
                         n: int = WY_TRACKS, seed: int = 0) -> None:
    """One-hot int8 matmul presence == scatter presence, bit for bit, and
    both == np.bincount."""
    import jax.numpy as jnp
    from ssrs_tpu.agents.simulate import TrackParams, _hist_padded
    rng = np.random.default_rng(seed)
    nrow, ncol = shape
    # clustered positions so many agents share cells, as tracks do
    r = np.clip(rng.normal(nrow / 2, nrow / 8, n), 0, nrow - 1).astype(
        np.int32)
    c = np.clip(rng.normal(ncol / 2, ncol / 8, n), 0, ncol - 1).astype(
        np.int32)
    wgt = (rng.random(n) < 0.8).astype(np.int32)
    nrow_p, ncol_p = TrackParams(grid_shape=shape, move_dirn=0., nu=1.,
                                 memory_k=1, burnin=1,
                                 nsteps=1).padded_grid
    args = (jnp.asarray(r), jnp.asarray(c), jnp.asarray(wgt), nrow_p,
            ncol_p)
    mm = np.asarray(_hist_padded(*args, use_matmul=True))
    sc = np.asarray(_hist_padded(*args, use_matmul=False))
    ref = np.bincount(r * ncol_p + c, weights=wgt,
                      minlength=nrow_p * ncol_p).reshape(nrow_p, ncol_p)
    log(f'  matmul precision: int8 x int8 -> int32 (exact; TF32 does '
        'not apply)')
    checks.check(f'presence {shape}, N={n}: cells where matmul != scatter',
                 int(np.sum(mm != sc)), 0)
    checks.check(f'presence {shape}, N={n}: cells where scatter != '
                 'np.bincount', int(np.sum(sc != ref)), 0)


def check_step_vs_oracle(checks: Checks, cond, potential,
                         n_device: int = WY_TRACKS, n_oracle: int = 3000,
                         nsteps: int = 120, seed: int = 0) -> None:
    """XLA step engine against the sequential NumPy oracle
    (tests/oracle_agents.py) on the same table, by the smoothed-presence
    L1 distance the tests use."""
    import jax
    from ssrs_tpu.agents import TrackParams, simulate_presence
    from ssrs_tpu.agents.presence import smooth_presence
    from oracle_agents import simulate_tracks_numpy
    shape = cond.shape
    rng = np.random.default_rng(seed)
    c0 = shape[1] // 2

    def starts(k):
        return np.stack([rng.integers(3, 6, k),
                         rng.integers(c0 - 12, c0 + 12, k)],
                        axis=1).astype(np.int32)

    params = TrackParams(grid_shape=shape, move_dirn=0., nu=1., memory_k=1,
                         burnin=int(min(shape) / 10), nsteps=nsteps,
                         weight_dtype='float32')
    pres, _ = simulate_presence(params, starts(n_device),
                                jax.random.key(seed), updraft=cond,
                                potential=potential)
    counts, _ = simulate_tracks_numpy(
        starts(n_oracle), shape, 0., 1., 1, nsteps,
        np.random.default_rng(seed + 1), updraft=cond, potential=potential)
    a = np.asarray(smooth_presence(np.asarray(pres), 3), np.float64)
    b = np.asarray(smooth_presence(counts.astype(np.int32), 3), np.float64)
    l1 = float(np.abs(a / a.sum() - b / b.sum()).sum())
    checks.check(f'XLA step {shape} (N={n_device}) vs sequential oracle '
                 f'(N={n_oracle}), {nsteps} steps: smoothed-presence L1',
                 l1, TOL_PRESENCE_L1)


def phase1(checks: Checks, shape=WY_SHAPE, n_agents: int = WY_TRACKS,
           ds_pairs: int = 1_000_000, n_oracle: int = 3000) -> None:
    import jax
    log(f'  default matmul precision: '
        f'{jax.config.jax_default_matmul_precision} (f32 dots on the '
        'path pass precision=HIGHEST or have TF32-exact operands)')
    check_ds(checks, n=ds_pairs)
    check_terrain(checks, shape)
    cond = wy_conductivity(shape)
    pot = check_solve(checks, cond)
    check_weights(checks, cond, pot)
    check_presence_paths(checks, shape, n_agents)
    check_step_vs_oracle(checks, cond, pot, n_device=n_agents,
                         n_oracle=n_oracle)


# ---- phase 2: the main path ----------------------------------------------

class CompileClock:
    """Sums XLA backend compile time reported by JAX's monitoring
    events while active."""

    EVENT = '/jax/core/compile/backend_compile_duration'

    def __init__(self):
        self.seconds = 0.
        self.count = 0

    def __call__(self, event, duration, **_):
        if event == self.EVENT:
            self.seconds += duration
            self.count += 1

    def __enter__(self):
        import jax
        jax.monitoring.register_event_duration_secs_listener(self)
        return self

    def __exit__(self, *exc):
        from jax._src import monitoring
        monitoring.unregister_event_duration_listener(self)


def _wy_config(out_dir: str, tracks: int, region=(60., 50.),
               res: float = 100.):
    from ssrs_tpu import Config
    return Config(run_name='wy', out_dir=out_dir, sim_mode='uniform',
                  sim_seed=7, southwest_lonlat=(-106.21, 42.78),
                  region_width_km=region, resolution=res,
                  uniform_winddirn=270., uniform_windspeed=10.,
                  track_count=tracks)


def _fallbacks(sim) -> list:
    return [r for r in sim.timer.records
            if r['phase'] == 'potential_finish' and r['fallback']]


def phase2(checks: Checks, out_dir: str, tracks: int = WY_TRACKS,
           region=(60., 50.), res: float = 100.,
           sweep=tuple(SWEEP_DIRNS)) -> None:
    import jax
    import jax.numpy as jnp
    from ssrs_tpu import Simulator
    from ssrs_tpu.agents import simulate_tracks_recorded, smooth_presence
    from ssrs_tpu.core.rng import case_key

    with CompileClock() as clock:
        t0 = time.perf_counter()
        sim = Simulator(_wy_config(out_dir, tracks, region, res))
        t_ctor = time.perf_counter() - t0
        t0 = time.perf_counter()
        sim.simulate_tracks()
        t_tracks = time.perf_counter() - t0
        t0 = time.perf_counter()
        summary = sim.compute_presence_map()
        t_map = time.perf_counter() - t0
    log(f'  grid {sim.gridsize}, {tracks} tracks; Simulator() '
        f'{t_ctor:.3f} s, simulate_tracks {t_tracks:.3f} s, '
        f'compute_presence_map {t_map:.3f} s; XLA compile '
        f'{clock.seconds:.3f} s in {clock.count} compilations')
    for r in sim.timer.records:
        extra = {k: v for k, v in r.items() if k not in ('phase', 'seconds')}
        log(f'    PhaseTimer {r["phase"]}: {r["seconds"]:.3f} s {extra}')
    checks.require('grid is the WY study size',
                   tuple(sim.gridsize) == tuple(
                       int(round(v * 1000 / res)) for v in region[::-1]),
                   str(sim.gridsize))

    case = sim.case_ids[0]
    id_str = sim._get_id_string(case, 0)
    data = sim.mode_data_dir
    paths = {k: os.path.join(data, f'{id_str}_{k}.npy')
             for k in ('potential', 'counts')}
    paths['orograph'] = os.path.join(data, f'{case}_orograph.npy')
    paths['summary'] = os.path.join(data, 'summary_presence.npy')
    for k, p in paths.items():
        checks.require(f'artifact {k} exists', os.path.isfile(p), p)
    oro = np.load(paths['orograph'])
    pot = np.load(paths['potential'])
    counts = np.load(paths['counts'])
    for k, arr in (('orograph', oro), ('potential', pot),
                   ('summary presence', summary)):
        checks.require(f'{k} has no NaN', not np.isnan(arr).any())
    checks.check('host float64 fallbacks among the main-path solves',
                 len(_fallbacks(sim)), 0)

    # conservation: every start deposits 1 and every alive step 1. The
    # recording driver counts lengths on the host from the per-step alive
    # emissions, independently of the on-device histogram.
    params = sim._track_params()
    key = case_key(sim.sim_seed, case, 0, 'tracks')
    rng = np.random.default_rng(sim.sim_seed)
    from ssrs_tpu.agents import get_starting_indices
    rows, cols = get_starting_indices(
        int(sim.track_count), list(sim.track_start_region),
        sim.track_start_type, tuple(sim.region_width_km),
        float(sim.resolution), rng=rng)
    starts = np.stack([rows, cols], axis=1).astype(np.int32)
    cond = sim.load_updrafts(case, apply_threshold=True)[0]
    t0 = time.perf_counter()
    pres_rec, tracks_rec = simulate_tracks_recorded(
        params, starts, key, updraft=cond, potential=pot)
    t_rec = time.perf_counter() - t0
    mass = int(np.asarray(pres_rec).sum(dtype=np.int64))
    useful = int(sum(len(t) - 1 for t in tracks_rec))
    log(f'  recording driver: {t_rec:.3f} s, presence mass {mass}, '
        f'useful steps {useful}, starts {len(tracks_rec)}')
    checks.check('|presence mass - (useful steps + starts)| (recording '
                 'driver)', abs(mass - (useful + len(tracks_rec))), 0)
    checks.require('main-path presence mass >= starts',
                   int(counts.sum(dtype=np.int64)) >= tracks)
    a = np.asarray(smooth_presence(jnp.asarray(counts), 3), np.float64)
    b = np.asarray(smooth_presence(pres_rec, 3), np.float64)
    checks.check('main path vs recording driver: smoothed-presence L1',
                 float(np.abs(a / a.sum() - b / b.sum()).sum()),
                 TOL_PRESENCE_L1)

    # the multi-case compacting driver: a direction sweep on the same grid
    n_before = len(_fallbacks(sim))
    with CompileClock() as clock:
        t0 = time.perf_counter()
        cases = sim.simulate_direction_sweep(list(sweep))
        t_sweep = time.perf_counter() - t0
    log(f'  simulate_direction_sweep({len(sweep)} directions): '
        f'{t_sweep:.3f} s; XLA compile {clock.seconds:.3f} s in '
        f'{clock.count} compilations')
    batched = [r for r in sim.timer.records
               if r['phase'] == 'batched_tracks']
    if batched:
        log(f'    PhaseTimer batched_tracks: {batched[-1]}')
    solves = [r for r in sim.timer.records
              if r['phase'] == 'potential_finish']
    log(f'    solver exit rrel per case: '
        f'{[float("%.3g" % r["rrel"]) for r in solves[-len(sweep):]]}')
    checks.check('host float64 fallbacks among the sweep solves',
                 len(_fallbacks(sim)) - n_before, 0)
    for cid in cases:
        sid = sim._get_id_string(cid, 0)
        cts = np.load(os.path.join(data, f'{sid}_counts.npy'))
        p = np.load(os.path.join(data, f'{sid}_potential.npy'))
        ok = (cts.sum(dtype=np.int64) >= tracks and not np.isnan(p).any())
        checks.require(f'sweep case {cid}: counts >= starts, potential '
                       'finite', ok, f'mass {int(cts.sum(dtype=np.int64))}')
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    log(f'  memory_stats peak_bytes_in_use: '
        f'{stats.get("peak_bytes_in_use", "not reported")}')


# ---- phase 3: bring-up timings -------------------------------------------

def _time_warm(fn, *args, reps: int = 5) -> float:
    """Median wall seconds of ``fn(*args)`` after one warm-up call, each
    call ended by block_until_ready."""
    import jax
    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def _gather_loop(k: int):
    """k chained 9-wide table gathers in one program: each iteration
    moves the indices so no two gathers are the same."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(table, idx):
        ncells = table.shape[0]

        def body(i, acc):
            j = (idx + i * 7919) % ncells
            rows = table.at[j].get(mode='promise_in_bounds')
            return acc + jnp.sum(rows.astype(jnp.float32), axis=0)
        return jax.lax.fori_loop(0, k, body, jnp.zeros((9,), jnp.float32))
    return run


def _hist_loop(k: int, nrow_p: int, ncol_p: int, use_matmul: bool):
    import jax
    import jax.numpy as jnp
    from ssrs_tpu.agents.simulate import _hist_padded

    @jax.jit
    def run(r, c, w):
        def body(i, acc):
            rr = (r + i) % nrow_p
            return acc + _hist_padded(rr, c, w, nrow_p, ncol_p, use_matmul)
        return jax.lax.fori_loop(0, k, body,
                                 jnp.zeros((nrow_p, ncol_p), jnp.int32))
    return run


def _per_iter(make, args, k_lo: int, k_hi: int) -> float:
    """Marginal seconds per loop iteration: (t(k_hi) - t(k_lo)) /
    (k_hi - k_lo), which cancels dispatch and launch overhead."""
    t_lo = _time_warm(make(k_lo), *args)
    t_hi = _time_warm(make(k_hi), *args)
    return (t_hi - t_lo) / (k_hi - k_lo)


def _step_per_step(shape, n: int, weight_dtype: str, presence_impl: str,
                   chunk: int = 64, trace_dir=None) -> float:
    """Seconds per XLA step (warm ``_run_chunk``, the compacting driver's
    jitted chunk) on a random table at ``shape`` with n agents kept away
    from the boundary."""
    import jax
    import jax.numpy as jnp
    from ssrs_tpu.agents import TrackParams, directional_probs, init_state
    from ssrs_tpu.agents.moves import restriction_table
    from ssrs_tpu.agents.simulate import _run_chunk, prepared_weights
    rng = np.random.default_rng(0)
    nrow, ncol = shape
    up = jnp.asarray(rng.uniform(0.5, 2., shape).astype(np.float32))
    pot = jnp.asarray(np.linspace(1000., 0., nrow, dtype=np.float32)[:, None]
                      * np.ones((1, ncol), np.float32))
    params = TrackParams(grid_shape=shape, move_dirn=0., nu=1., memory_k=1,
                         burnin=0, nsteps=1 << 30, weight_dtype=weight_dtype,
                         presence_impl=presence_impl)
    dirp = jnp.asarray(directional_probs(0.))
    table = jnp.asarray(restriction_table())
    base = prepared_weights(up, pot, dirp, weight_dtype)
    starts = np.stack([rng.integers(nrow // 4, 3 * nrow // 4, n),
                       rng.integers(ncol // 4, 3 * ncol // 4, n)],
                      axis=1).astype(np.int32)
    state = init_state(params, jnp.asarray(starts), jax.random.key(0))

    def run(st):
        return _run_chunk(params, base, dirp, table, st, chunk)[0]

    dt = _time_warm(run, state) / chunk
    if trace_dir is not None:
        jax.block_until_ready(run(state))
        with jax.profiler.trace(trace_dir):
            for _ in range(3):
                jax.block_until_ready(run(state))
    return dt


def trace_device_summary(trace_dir: str, top: int = 12) -> None:
    """Reduce a profiler trace to device busy time, idle share over the
    traced device window, and the kernels that took the most time."""
    import glob
    from jax.profiler import ProfileData
    files = sorted(glob.glob(os.path.join(
        trace_dir, 'plugins', 'profile', '*', '*.xplane.pb')))
    if not files:
        raise RuntimeError(f'no .xplane.pb under {trace_dir}')
    prof = ProfileData.from_file(files[-1])
    found = False
    for plane in prof.planes:
        if not plane.name.startswith('/device:GPU'):
            continue
        found = True
        per_kernel = {}
        spans = []
        for line in plane.lines:
            if not line.name.startswith('Stream'):
                continue
            for ev in line.events:
                dur = ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + dur))
                tot, cnt = per_kernel.get(ev.name, (0., 0))
                per_kernel[ev.name] = (tot + dur, cnt + 1)
        if not spans:
            log(f'  {plane.name}: no stream events; lines '
                f'{[ln.name for ln in plane.lines]}')
            continue
        spans.sort()
        busy, cur_s, cur_e = 0., spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
        log(f'  {plane.name}: {len(spans)} device events, '
            f'{len(per_kernel)} distinct kernels, busy {busy / 1e6:.3f} ms '
            f'of a {window / 1e6:.3f} ms device window (idle share '
            f'{1 - busy / max(window, 1):.3f})')
        for name, (tot, cnt) in sorted(per_kernel.items(),
                                       key=lambda kv: -kv[1][0])[:top]:
            log(f'    {tot / 1e6:9.3f} ms  x{cnt:<5d} {name[:90]}')
    if not found:
        log(f'  no GPU plane in the trace (planes: '
            f'{[p.name for p in prof.planes]})')


def phase3(checks: Checks, out_dir: str, n: int = WY_TRACKS,
           gather_shapes=((500, 600), (1200, 1400), (4096, 4096)),
           presence_shapes=((500, 600), (1200, 1400), (2048, 2048)),
           step_shapes=((500, 600), (1200, 1400))) -> None:
    import jax
    import jax.numpy as jnp
    from ssrs_tpu.agents.simulate import TrackParams
    log('  (bring-up measurements, not benchmark cells; warm, each call '
        'ended by block_until_ready)')
    rng = np.random.default_rng(0)
    for shape in gather_shapes:
        cells = shape[0] * shape[1]
        idx = jnp.asarray(rng.integers(0, cells, n).astype(np.int32))
        row = []
        for dt in ('float32', 'bfloat16'):
            table = jnp.asarray(rng.random((cells, 9), np.float32)).astype(
                dt)
            per = _per_iter(_gather_loop, (table, idx), 8, 72)
            row.append(f'{dt} {per * 1e6:.2f} us/gather '
                       f'({per / n * 1e9:.3f} ns/row, table '
                       f'{table.nbytes / 2 ** 20:.1f} MiB)')
            del table
        log(f'  gather N={n} at {shape}: ' + '; '.join(row))
    for shape in presence_shapes:
        nrow_p, ncol_p = TrackParams(grid_shape=shape, move_dirn=0., nu=1.,
                                     memory_k=1, burnin=0,
                                     nsteps=1).padded_grid
        r = jnp.asarray(rng.integers(0, shape[0], n).astype(np.int32))
        c = jnp.asarray(rng.integers(0, shape[1], n).astype(np.int32))
        w = jnp.ones((n,), jnp.int32)
        row = []
        for impl in ('scatter', 'matmul'):
            per = _per_iter(
                lambda k, impl=impl: _hist_loop(k, nrow_p, ncol_p,
                                                impl == 'matmul'),
                (r, c, w), 4, 36)
            row.append(f'{impl} {per * 1e6:.2f} us')
        log(f'  presence histogram N={n} at {shape} '
            f'({shape[0] * shape[1] / 1e6:.2f}M cells): ' + '; '.join(row))
    for shape in step_shapes:
        row = []
        for dt, impl in (('float32', 'scatter'), ('bfloat16', 'scatter'),
                         ('float32', 'matmul')):
            per = _step_per_step(shape, n, dt, impl)
            row.append(f'{dt}/{impl} {per * 1e6:.2f} us/step')
        log(f'  XLA step N={n} at {shape}: ' + '; '.join(row))
    trace_dir = os.path.join(out_dir, 'step_trace')
    per = _step_per_step(WY_SHAPE, n, 'auto', 'auto', trace_dir=trace_dir)
    log(f'  XLA step with the auto policies at {WY_SHAPE}, N={n}: '
        f'{per * 1e6:.2f} us/step; trace of 3 x 64 steps in {trace_dir}')
    trace_device_summary(trace_dir)


# ---- phase 4: card-only tests --------------------------------------------

def phase4(checks: Checks) -> None:
    import pytest
    os.environ['SSRS_TESTS_ON_DEVICE'] = '1'
    rc = pytest.main(['-q', '-m', 'gpu', '-p', 'no:cacheprovider',
                      os.path.join(REPO, 'tests', 'test_gpu.py')])
    checks.check('pytest -m gpu exit code', int(rc), 0)


# ---- four cards ----------------------------------------------------------

def _on_devices(arr) -> set:
    return {d.id for d in arr.devices()}


def four_cards(checks: Checks, n_dev: int = 4, tracks: int = WY_TRACKS,
               shape=WY_SHAPE, field_shape=(4096, 4096),
               n_cases: int = 8) -> None:
    """The multi-device paths, each beside its one-device comparison."""
    import jax
    import jax.numpy as jnp
    from ssrs_tpu.agents import (TrackParams, directional_probs,
                                 prepared_weights, smooth_presence)
    from ssrs_tpu.agents.simulate import simulate_presence_cases_compacting
    from ssrs_tpu.parallel import (make_mesh,
                                   simulate_presence_sharded_compacting)
    from ssrs_tpu.parallel.fields import (make_field_mesh,
                                          solve_potential_refined_sharded)
    from ssrs_tpu.parallel.mesh import _init_sharded_fn, pad_to_multiple
    from ssrs_tpu.potential import boundary_masks, solve_potential_refined

    devices = jax.devices()[:n_dev]
    checks.require(f'{n_dev} devices present', len(devices) == n_dev,
                   str(jax.devices()))
    params = TrackParams(grid_shape=shape, move_dirn=0., nu=1., memory_k=1,
                         burnin=int(min(shape) / 10), nsteps=10_000)
    rng = np.random.default_rng(0)
    starts = np.stack([rng.integers(3, 20, tracks),
                       rng.integers(shape[1] // 4, 3 * shape[1] // 4,
                                    tracks)],
                      axis=1).astype(np.int32)

    # 1. case-spread sweep: one case per device, results per case equal.
    # The driver is under test, not the solver: each case's table pairs
    # its own wind direction's conductivity with a north-south ramp
    # potential.
    conds = [wy_conductivity(shape, dirn=360. * i / n_cases)
             for i in range(n_cases)]
    ramp = jnp.asarray(np.linspace(1000., 0., shape[0], dtype=np.float32)
                       [:, None] * np.ones((1, shape[1]), np.float32))
    dirp = jnp.asarray(directional_probs(0.))
    tables = [prepared_weights(jnp.asarray(conds[i]), ramp, dirp,
                               'float32') for i in range(n_cases)]
    keys = list(jax.random.split(jax.random.key(3), n_cases))
    t0 = time.perf_counter()
    p1, s1 = simulate_presence_cases_compacting(params, tables, starts,
                                                keys)
    p1 = np.asarray(p1)
    t1 = time.perf_counter() - t0
    placed = [jax.device_put(tables[i], devices[i % n_dev])
              for i in range(n_cases)]
    checks.require('case tables spread one per device',
                   [_on_devices(t) for t in placed]
                   == [{devices[i % n_dev].id} for i in range(n_cases)],
                   str([sorted(_on_devices(t)) for t in placed]))
    t0 = time.perf_counter()
    pn, sn = simulate_presence_cases_compacting(params, placed, starts,
                                                keys, devices=devices)
    pn = np.asarray(pn)
    tn = time.perf_counter() - t0
    log(f'  case-spread sweep, {n_cases} cases x {tracks} tracks at '
        f'{shape}: 1 device {t1:.3f} s, {n_dev} devices {tn:.3f} s '
        '(first calls include compiles)')
    checks.check(f'case-spread sweep: cells differing from the 1-device '
                 'run', int(np.sum(p1 != pn)), 0)

    # 2. agent-sharded compacting driver at n_dev x tracks
    mesh = make_mesh(devices=devices)
    big = np.concatenate([starts] * n_dev)
    padded, valid = pad_to_multiple(big, n_dev)
    st = _init_sharded_fn(params, mesh)(jnp.asarray(padded),
                                        jnp.asarray(valid),
                                        jax.random.key(5))
    shard_devs = sorted(s.device.id for s in st[0].addressable_shards)
    checks.require('agent shards one per device',
                   shard_devs == sorted(d.id for d in devices)
                   and all(s.data.shape[0] == padded.shape[0] // n_dev
                           for s in st[0].addressable_shards),
                   str(shard_devs))
    t0 = time.perf_counter()
    ps, _ = simulate_presence_sharded_compacting(
        params, big, jax.random.key(5), updraft=conds[0], potential=ramp,
        mesh=mesh)
    ps = np.asarray(ps)
    tn = time.perf_counter() - t0
    from ssrs_tpu.agents import simulate_presence_compacting
    t0 = time.perf_counter()
    p_one, _ = simulate_presence_compacting(
        params, big, jax.random.key(6), updraft=conds[0],
        potential=ramp)
    p_one = np.asarray(p_one)
    t1 = time.perf_counter() - t0
    log(f'  agent-sharded compacting driver, {big.shape[0]} tracks: '
        f'1 device {t1:.3f} s, {n_dev} devices {tn:.3f} s')
    a = np.asarray(smooth_presence(jnp.asarray(ps), 3), np.float64)
    b = np.asarray(smooth_presence(jnp.asarray(p_one), 3), np.float64)
    checks.check('agent-sharded vs 1-device: smoothed-presence L1',
                 float(np.abs(a / a.sum() - b / b.sum()).sum()),
                 TOL_PRESENCE_L1)
    checks.require('agent-sharded presence mass >= starts',
                   int(ps.sum(dtype=np.int64)) >= big.shape[0])

    # 3. row-sharded refined solve
    cond = wy_conductivity(field_shape)
    fb, fv = boundary_masks(0., field_shape)
    t0 = time.perf_counter()
    want, rrel1 = solve_potential_refined(cond, fb, fv)
    want = np.asarray(want)
    t1 = time.perf_counter() - t0
    fmesh = make_field_mesh(devices=devices)
    t0 = time.perf_counter()
    got, rreln = solve_potential_refined_sharded(cond, fb, fv, mesh=fmesh)
    shard_devs = sorted(s.device.id for s in got.addressable_shards)
    got = np.asarray(got)
    tn = time.perf_counter() - t0
    log(f'  refined solve {field_shape}: 1 device {t1:.3f} s (rrel '
        f'{float(rrel1):.3g}), {n_dev} devices row-sharded {tn:.3f} s '
        f'(rrel {float(rreln):.3g}); both include compiles')
    checks.require('row-sharded solve output spans every device',
                   shard_devs == sorted(d.id for d in devices),
                   str(shard_devs))
    checks.check('row-sharded vs 1-device solve: max |diff| (0-1000 scale)',
                 float(np.abs(got - want).max()), TOL_SOLVE_ABS)
    checks.check('row-sharded solve relative residual', float(rreln),
                 5e-3)


# ---- main ----------------------------------------------------------------

def device_report(want_count: int):
    """Phase 0. Returns the device summary for the result line; exits
    non-zero when JAX's default device is not a GPU."""
    import jax
    import jaxlib
    devs = jax.devices()
    if devs[0].platform != 'gpu':
        log(f'chip_smoke: needs an NVIDIA GPU, but JAX\'s default device '
            f'is {devs[0].platform!r} ({devs[0].device_kind}); nothing '
            'was run')
        sys.exit(2)
    if len(devs) < want_count:
        log(f'chip_smoke: needs {want_count} GPUs, found {len(devs)}')
        sys.exit(2)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f'card: {line.strip()}')
    from ssrs_tpu.simulator import _enable_compile_cache
    cache = _enable_compile_cache()
    log(f'jax {jax.__version__}, jaxlib {jaxlib.__version__}; '
        f'device_kind {devs[0].device_kind!r}, {len(devs)} devices; '
        f'XLA_FLAGS={os.environ.get("XLA_FLAGS", "")!r}; compile cache '
        f'{cache}')
    return {'platform': devs[0].platform, 'kind': devs[0].device_kind,
            'count': len(devs)}


def run_phase(checks: Checks, name: str, fn, *args) -> None:
    log(f'== {name}')
    t0 = time.perf_counter()
    n_failed = len(checks.failed)
    try:
        fn(checks, *args)
    except Exception:  # noqa: BLE001 — a phase boundary: report, go on,
        # and exit non-zero at the end
        traceback.print_exc(file=sys.stdout)
        checks.failed.append(f'{name} raised')
    status = 'ok' if len(checks.failed) == n_failed else 'FAILED'
    log(f'== {name}: {status} in {time.perf_counter() - t0:.1f} s')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the multi-device paths, on four GPUs')
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    device = device_report(4 if args.four_cards else 1)
    os.makedirs(OUT_DIR, exist_ok=True)
    checks = Checks()
    t0 = time.perf_counter()
    if args.four_cards:
        run_phase(checks, 'four cards', four_cards)
    else:
        import tempfile
        with tempfile.TemporaryDirectory(dir=OUT_DIR) as work:
            run_phase(checks, 'phase 1: numerics vs references', phase1)
            run_phase(checks, 'phase 2: Simulator main path', phase2, work)
        run_phase(checks, 'phase 3: bring-up timings', phase3, OUT_DIR)
        run_phase(checks, 'phase 4: card-only tests', phase4)
    log(f'total {time.perf_counter() - t0:.1f} s')
    if checks.failed:
        log(f'chip_smoke FAILED: {checks.failed}')
        return 1
    print(json.dumps({'ok': True, 'device': device}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
