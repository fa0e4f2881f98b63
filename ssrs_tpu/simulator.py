"""The ``Simulator`` facade: Config-driven end-to-end pipeline.

API and artifact parity with the reference ``ssrs.Simulator``
(ssrs/simulator.py:34-804): identical constructor flow (region setup ->
terrain -> turbines -> wind -> updraft fields), identical output-directory
layout and artifact naming
(``{case_id}_{d<dirn>}_{t<thr*100>}_{model}[_r<real>]_<artifact>``), the
same uniform/snapshot/seasonal modes, and the same public methods.

Differences by design (JAX device engine):
- track simulation runs as a lockstep device scan over all agents
  (ssrs_tpu.agents.simulate) instead of a process pool; presence maps
  accumulate on device, so ``track_count`` can be 100k+;
- ``_tracks.pkl`` files are still written (list of int16 (row, col)
  trajectories, same format) whenever the run is small enough to
  materialize trajectories (``track_count <= Config.track_pkl_budget``),
  alongside a ``_counts.npy`` presence-count artifact that the presence
  plots prefer;
- randomness is keyed (ssrs_tpu.core.rng), not global-NumPy-state;
- the directional potential is solved by the device multigrid or the
  host float64 direct solver (see ssrs_tpu/potential/direct.py for the
  precision discussion); 'auto' picks the direct solver for
  reference-exact numerics.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from dataclasses import asdict
from datetime import datetime
from typing import List, Optional, Tuple

import numpy as np

import jax

from .config import Config
from .core.grid import Grid
from .core.rng import case_key, root_key
from .core.timing import PhaseTimer, elapsed_str
from .agents import TrackParams, get_starting_indices
from .agents.simulate import simulate_tracks_recorded
from .fields import (compute_aspect_degrees, compute_orographic_updraft,
                     compute_slope_degrees, compute_thermals,
                     get_above_threshold_speed)
from .data import (Terrain, TurbinesUSWTB, get_raster_in_projected_crs,
                   transform_bounds, transform_coordinates)
from .plotting import PlottingMixin
from .utils import get_seasonal_datetimes_list, makedir_if_not_exists


class Simulator(PlottingMixin, Config):
    """SSRS simulation orchestrator (reference: ssrs/simulator.py:34)."""

    lonlat_crs = 'EPSG:4326'
    time_format = 'y%Ym%md%dh%H'

    def __init__(self, in_config: Config = None, **kwargs) -> None:
        if in_config is None:
            super().__init__(**kwargs)
        else:
            super().__init__(**asdict(in_config))
        print(f'\n---- SSRS in {self.sim_mode} mode')
        print(f'Run name: {self.run_name}')

        _enable_compile_cache()
        # SSRS_TPU_TRACE_DIR=<dir> wraps compute phases in jax.profiler
        # traces viewable with TensorBoard/xprof
        self._trace_dir = os.environ.get('SSRS_TPU_TRACE_DIR')
        self.timer = PhaseTimer(trace_dir=self._trace_dir)
        self._rng = np.random.default_rng(
            self.sim_seed if self.sim_seed >= 0 else None)
        if self.sim_seed >= 0:
            print('Specified random number seed:', self.sim_seed)

        # directories (ssrs/simulator.py:54-61)
        print(f'Output dir: {os.path.join(self.out_dir, self.run_name)}')
        self.data_dir = os.path.join(self.out_dir, self.run_name, 'data/')
        self.fig_dir = os.path.join(self.out_dir, self.run_name, 'figs/')
        self.mode_data_dir = os.path.join(self.data_dir, self.sim_mode)
        self.mode_fig_dir = os.path.join(self.fig_dir, self.sim_mode)
        for dirname in (self.mode_data_dir, self.mode_fig_dir):
            makedir_if_not_exists(dirname)

        # config dump (ssrs/simulator.py:63-67)
        fpath = os.path.join(self.out_dir, self.run_name,
                             f'{self.run_name}.json')
        with open(fpath, 'w', encoding='utf-8') as cfile:
            json.dump({k: v for k, v in self.__dict__.items()
                       if not k.startswith('_') and _jsonable(v)},
                      cfile, ensure_ascii=False, indent=2, default=str)

        # grid geometry (ssrs/simulator.py:69-85), captured as a Grid value
        print(f'Terrain resolution = {self.resolution} m')
        proj_west, proj_south = transform_coordinates(
            self.lonlat_crs, self.projected_crs,
            self.southwest_lonlat[0], self.southwest_lonlat[1])
        self.grid = Grid.from_region(
            tuple(self.region_width_km), self.resolution,
            (float(np.asarray(proj_west).ravel()[0]),
             float(np.asarray(proj_south).ravel()[0])))
        self.gridsize = self.grid.shape
        print(f'Terrain grid size = {self.gridsize}')
        self.bounds = self.grid.bounds
        self.extent = self.grid.extent
        self.lonlat_bounds = transform_bounds(
            self.bounds, self.projected_crs, self.lonlat_crs)

        # terrain layers (ssrs/simulator.py:87-99), with the offline
        # synthetic fallback appended to the reference's 3DEP->SRTM chain
        self.region = Terrain(self.lonlat_bounds, self.data_dir)
        with self.timer.phase('terrain'):
            self._setup_terrain()

        # turbines (ssrs/simulator.py:101-105)
        turbine_fpath = os.path.join(self.mode_data_dir, 'turbines.csv')
        with self.timer.phase('turbines'):
            self.turbines = TurbinesUSWTB(
                self.bounds, self.projected_crs,
                self.turbine_minimum_hubheight, turbine_fpath,
                self.print_verbose)

        # WTK layer names (ssrs/simulator.py:107-115)
        self.wtk_layers = {
            'wspeed': f'windspeed_{int(self.wtk_orographic_height)}m',
            'wdirn': f'winddirection_{int(self.wtk_orographic_height)}m',
            'pressure': f'pressure_{int(self.wtk_thermal_height)}m',
            'temperature': f'temperature_{int(self.wtk_thermal_height)}m',
            'blheight': 'boundary_layer_height',
            'surfheatflux': 'surface_heat_flux',
        }

        # mode dispatch (ssrs/simulator.py:117-133)
        if self.sim_mode.lower() != 'uniform':
            from .data import WTK
            wtk_kw = {}
            if self.wtk_source == 'LOCAL':
                wtk_kw = dict(local_template=self.wtk_local_template,
                              local_years=list(self.wtk_local_years))
            self.wtk = WTK(self.wtk_source, self.lonlat_bounds,
                           list(self.wtk_layers.values()),
                           self.mode_data_dir, **wtk_kw)
            if self.sim_mode.lower() == 'seasonal':
                self.dtimes = self.get_seasonal_datetimes()
            elif self.sim_mode.lower() == 'snapshot':
                self.dtimes = [datetime(*self.snapshot_datetime)]
            self.wtk.download_data(self.dtimes, self.max_cores)
            self.case_ids = [dt.strftime(self.time_format)
                             for dt in self.dtimes]
            with self.timer.phase('updrafts'):
                self.compute_orographic_updrafts_using_wtk()
        else:
            print(f'Uniform mode: Wind speed = {self.uniform_windspeed} m/s')
            print(f'Uniform mode: Wind dirn = {self.uniform_winddirn} '
                  'deg(cw)')
            self.case_ids = [self._get_uniform_id()]
            with self.timer.phase('updrafts'):
                self.compute_orographic_updraft_uniform()

        for case_id in self.case_ids:
            self.compute_thermal_updrafts(case_id)

        # plotting settings (ssrs/simulator.py:138-142)
        fig_aspect = self.region_width_km[0] / self.region_width_km[1]
        self.fig_size = (self.fig_height * fig_aspect, self.fig_height)
        self.km_bar = min([1, 5, 10], key=lambda x: abs(
            x - self.region_width_km[0] // 4))
        print('SSRS Simulator initiation done.')

    # ---- terrain ---------------------------------------------------------

    def _setup_terrain(self):
        """3DEP -> SRTM -> synthetic source chain
        (ssrs/simulator.py:87-99 + offline fallback)."""
        try:
            self.terrain_layers = {
                'Elevation': 'DEM',
                'Slope': 'Slope Degrees',
                'Aspect': 'Aspect Degrees',
            }
            self.region.download(list(self.terrain_layers.values()))
        except Exception:
            print('Connection issues with 3DEP WMS service! Trying SRTM1..')
            try:
                self.terrain_layers = {'Elevation': 'SRTM1'}
                self.region.download(list(self.terrain_layers.values()))
            except Exception:
                print('SRTM unavailable too! Using synthetic terrain '
                      '(offline mode).')
                self.terrain_layers = {'Elevation': 'SYNTHETIC'}
                self.region.download(list(self.terrain_layers.values()))

    def get_terrain_elevation(self):
        return self.get_terrain_layer('Elevation')

    def get_terrain_slope(self):
        """Slope layer, or Horn-stencil recompute from the DEM
        (ssrs/simulator.py:152-159)."""
        try:
            return self.get_terrain_layer('Slope')
        except Exception:
            elev = self.get_terrain_elevation()
            return np.asarray(compute_slope_degrees(elev, self.resolution))

    def get_terrain_aspect(self):
        try:
            return self.get_terrain_layer('Aspect')
        except Exception:
            elev = self.get_terrain_elevation()
            return np.asarray(compute_aspect_degrees(elev, self.resolution))

    def get_terrain_layer(self, lname: str):
        return get_raster_in_projected_crs(
            self.region.get_raster_fpath(self.terrain_layers[lname]),
            self.bounds, self.gridsize, self.resolution,
            self.projected_crs)

    def get_terrain_grid(self):
        """(xgrid, ygrid) (ssrs/simulator.py:177-185)."""
        return self.grid.xy_grid()

    # ---- updrafts --------------------------------------------------------

    def compute_orographic_updraft_uniform(self) -> None:
        """Uniform-mode orographic updraft (ssrs/simulator.py:189-198)."""
        print('Computing orographic updrafts..')
        slope = self.get_terrain_slope()
        aspect = self.get_terrain_aspect()
        orograph = compute_orographic_updraft(
            float(self.uniform_windspeed) * np.ones(self.gridsize,
                                                    np.float32),
            float(self.uniform_winddirn) * np.ones(self.gridsize,
                                                   np.float32),
            slope.astype(np.float32), aspect.astype(np.float32))
        fname = self._get_orograph_fname(self.case_ids[0],
                                         self.mode_data_dir)
        np.save(f'{fname}.npy', np.asarray(orograph, np.float32))

    def compute_orographic_updrafts_using_wtk(self) -> None:
        """Per-datetime WTK-interpolated updrafts
        (ssrs/simulator.py:200-215)."""
        print('Computing orographic updrafts..', end='')
        slope = self.get_terrain_slope().astype(np.float32)
        aspect = self.get_terrain_aspect().astype(np.float32)
        start_time = time.time()
        for dtime, case_id in zip(self.dtimes, self.case_ids):
            wtk_df = self.wtk.get_dataframe_for_this_time(dtime)
            wspeed, wdirn = self._get_interpolated_wind_conditions(
                wtk_df[self.wtk_layers['wspeed']],
                wtk_df[self.wtk_layers['wdirn']])
            orograph = compute_orographic_updraft(
                wspeed.astype(np.float32), wdirn.astype(np.float32),
                slope, aspect)
            fname = self._get_orograph_fname(case_id, self.mode_data_dir)
            np.save(f'{fname}.npy', np.asarray(orograph, np.float32))
        print(f'took {elapsed_str(start_time)}', flush=True)

    def compute_thermal_updrafts(self, case_id: str) -> None:
        """Thermal realizations (ssrs/simulator.py:217-228)."""
        if self.thermals_realization_count > 0:
            print('Computing thermal updrafts...', flush=True)
            aspect = self.get_terrain_aspect().astype(np.float32)
            for real_id in range(self.thermals_realization_count):
                key = case_key(self.sim_seed, case_id, real_id, 'thermals')
                thermals = compute_thermals(key, aspect, 2.0)
                fname = self._get_thermal_fname(case_id, real_id,
                                                self.mode_data_dir)
                np.save(f'{fname}.npy', np.asarray(thermals, np.float32))
        else:
            print('No thermals requested!', flush=True)

    def load_updrafts(self, case_id: str, apply_threshold: bool = True,
                      device: bool = False) -> List[np.ndarray]:
        """Orographic [+ thermal] updrafts, optionally thresholded
        (ssrs/simulator.py:230-243). With ``device=True`` the
        thresholded fields are returned as device arrays (the threshold
        runs on device either way; this skips the host pull so a
        multi-case prep can keep its conductivities resident —
        Config.fields_device)."""
        fname = self._get_orograph_fname(case_id, self.mode_data_dir)
        orograph = np.load(f'{fname}.npy')
        updrafts = [orograph]
        for real_id in range(int(self.thermals_realization_count)):
            fname = self._get_thermal_fname(case_id, real_id,
                                            self.mode_data_dir)
            updrafts.append(orograph + np.load(f'{fname}.npy'))
        if apply_threshold:
            thresholded = [get_above_threshold_speed(
                ix, self.updraft_threshold) for ix in updrafts]
            updrafts = thresholded if device else \
                [np.asarray(ix) for ix in thresholded]
        return updrafts

    def _get_orograph_fname(self, case_id: str, dirname: str = './'):
        return os.path.join(dirname, f'{case_id}_orograph')

    def _get_thermal_fname(self, case_id: str, real_id: int,
                           dirname: str = './'):
        return os.path.join(dirname, f'{case_id}_r{real_id}_thermals')

    # ---- directional potential ------------------------------------------

    def get_directional_potential(self, updraft, case_id, real_id):
        """Cached directional-potential solve
        (ssrs/simulator.py:259-288)."""
        return self.finish_directional_potential(
            self.begin_directional_potential(updraft, case_id, real_id))

    def _check_potential_cache(self, case_id, real_id):
        """Returns (cached-state-or-None, fname, id_str)."""
        fname = self._get_potential_fname(case_id, real_id,
                                          self.mode_data_dir)
        id_str = self._get_id_string(case_id, real_id)
        try:
            potential = np.load(f'{fname}.npy')
            if potential.shape != tuple(self.gridsize):
                raise FileNotFoundError
            if (self.sim_seed < 0) and (real_id != 0):
                raise FileNotFoundError
            print(f'{id_str}: Found saved potential')
            return ('cached', potential, fname, id_str, 0.), fname, id_str
        except FileNotFoundError:
            return None, fname, id_str

    def begin_directional_potential(self, updraft, case_id, real_id):
        """Cache-check + ASYNC solve dispatch for one (case,
        realization): returns an opaque handle for
        :meth:`finish_directional_potential`. Splitting the solve lets
        a multi-case prep loop overlap the host work of case *i+1*
        (island labeling + tile-hierarchy build) and the device solve
        of case *i* — the refined solve is a single async jit dispatch,
        so nothing blocks until the residual is read at finish time."""
        state, fname, id_str = self._check_potential_cache(case_id,
                                                           real_id)
        if state is not None:
            return state
        start_time = time.time()
        if not isinstance(updraft, jax.Array):
            updraft = np.asarray(updraft)
        handle = self._begin_potential_solve(updraft)
        return ('solve', handle, fname, id_str, start_time)

    def _potential_batch_cap(self) -> int:
        """How many uncached refined solves one vmapped program may
        carry (Config.potential_batch: 0 = auto, 1 = off, >1 = cap).

        Auto is OFF: on the previous accelerator pipelined sequential
        solves beat batched groups at every grid tried (not yet
        re-measured on the GPU). Batched convergence is also
        composition-fragile on
        ill-conditioned fields: cases that solve to 3e-7 alone (and
        under any perturbation) exit at 3e-3 inside batches of >= 4 —
        still inside the 5e-3 safety net, but strictly worse
        (docs/DESIGN.md "Round 5: the batched-solve reversal").
        Explicit ``potential_batch > 1`` keeps the vmapped path
        available, bounded by the ~200 B/cell/case memory envelope."""
        pb = int(self.potential_batch)
        if pb <= 1:
            return 1
        cells = int(np.prod(self.gridsize))
        return max(1, min(pb, int(3.5e9 // (cells * 200))))

    def begin_directional_potentials(self, items):
        """Multi-case prep: cache-check every ``(updraft, case_id,
        real_id)`` item and dispatch the uncached solves as BATCHED
        vmapped refined-solve programs in power-of-two groups (see
        ``solve_potential_refined_batch`` — explicit-opt-in only since
        the round-5 reversal: sequential pipelined solves measure
        faster at every grid tried). Returns
        one :meth:`finish_directional_potential` handle per item, in
        order; the per-case residual/fallback policy is unchanged
        (each batched case finishes through the same handle kind)."""
        states = [None] * len(items)
        todo = []
        for i, (updraft, case_id, real_id) in enumerate(items):
            state, fname, id_str = self._check_potential_cache(case_id,
                                                               real_id)
            if state is not None:
                states[i] = state
            else:
                todo.append((i, updraft, fname, id_str))
        solver = (self.potential_solver or 'auto').lower()
        cap = self._potential_batch_cap()
        # quantize the group size to a power of two: every distinct
        # batch size is its own XLA executable
        cap = 1 << max(0, cap.bit_length() - 1)
        if solver not in ('auto', 'refined') or cap <= 1 or len(todo) < 2:
            for i, updraft, fname, id_str in todo:
                states[i] = ('solve',
                             self._begin_potential_solve(
                                 np.asarray(updraft)),
                             fname, id_str, time.time())
            return states
        from .potential import solve_potential_refined_batch
        from .potential.boundary import boundary_masks
        bmask, bvals = boundary_masks(self.track_direction,
                                      tuple(self.gridsize))
        maxiter = self.potential_maxiter if self.potential_maxiter > 0 \
            else 60
        pos = 0
        while pos < len(todo):
            n_left = len(todo) - pos
            if n_left == 1:
                # a lone remainder reuses the (already-compiled)
                # single-case executable instead of a padded batch
                i, updraft, fname, id_str = todo[pos]
                states[i] = ('solve',
                             self._begin_potential_solve(
                                 np.asarray(updraft)),
                             fname, id_str, time.time())
                break
            b = min(cap, 1 << (n_left - 1).bit_length())
            group = todo[pos:pos + b]
            t0 = time.time()
            conds = [np.asarray(u) for (_, u, _, _) in group]
            # pad a short tail group up to its power of two by repeating
            # the last field (the padded lanes' results are dropped)
            conds_in = conds + [conds[-1]] * (b - len(group))
            pots, resids = solve_potential_refined_batch(
                conds_in, bmask, bvals, tol=float(self.potential_tol),
                maxcycles=maxiter)
            for j, (i, _, fname, id_str) in enumerate(group):
                states[i] = ('solve',
                             ('refined', (conds[j], pots[j], resids[j])),
                             fname, id_str, t0)
            pos += len(group)
        return states

    def finish_directional_potential(self, state) -> np.ndarray:
        """Materialize a :meth:`begin_directional_potential` handle:
        read the residual, apply the f64-fallback policy, save the
        artifact. Under pipelining the printed wall includes the
        overlapped device time (it is the same wall a serial caller
        would have seen)."""
        return self._finish_directional_potential_pair(state)[0]

    def _finish_directional_potential_pair(self, state):
        """finish_directional_potential, returning ``(host, device)``:
        the host array backs the ``.npy`` artifact (and the fallback
        path), while the device array — None for cached/fallback
        results — lets the batched weight-table build skip the
        host→device re-upload of fields the solver just produced
        (the measured bound of the Appalachian sweep's table phase:
        ~160 MB / 6.2 s for 24 cases, docs/DESIGN.md)."""
        kind, payload, fname, id_str, start_time = state
        if kind == 'cached':
            potential, dev = payload, None
        else:
            potential, dev = self._finish_potential_solve_pair(payload)
            print(f'{id_str}: Computing potential..'
                  f'took {elapsed_str(start_time)}', flush=True)
            np.save(f'{fname}.npy', potential.astype(np.float32))
        if np.isnan(potential).any():
            print('NANs found in potential!')
        return potential, dev

    def _device_fields_fit(self, n_fields: int) -> bool:
        """Whether the device-resident prep (Config.fields_device) may
        park ``n_fields`` conductivities AND potentials on the device
        for the whole prep. Past the guard the host-materialized flow
        runs instead: parking defeats the bounded finish depth (depth 1
        past 4096^2 — see _prepare_potentials), so grids beyond that
        boundary never park, and below it the resident set is capped at
        ~1.5 GB (2 f32 fields per case). Both caps were sized for a
        16 GB device and have not been re-derived for an 80 GB one."""
        if not bool(self.fields_device):
            return False
        cells = int(np.prod(self.gridsize))
        if cells > 4096 * 4096:
            return False
        return cells * max(1, n_fields) * 8 <= 1_500_000_000

    def _prepare_potentials(self, items, pairs: bool = False):
        """Potentials for a list of ``(case_id, real_id, updraft)`` work
        items, in order. Where the batched vmapped solve applies
        (refined solver, batch cap > 1, >1 item) the items run through
        :meth:`begin_directional_potentials` in bounded windows (at
        most ``4 * cap`` unmaterialized potentials parked on device);
        otherwise the per-case pipelined dispatch with the bounded
        finish depth (3, or 1 past 4096^2, a cap sized for a 16 GB
        device — docs/DESIGN.md "COO deflation").

        With ``pairs=True`` every element is ``(host, device-or-None)``
        (see :meth:`_finish_directional_potential_pair`); otherwise
        plain host arrays."""
        finish = (self._finish_directional_potential_pair if pairs
                  else self.finish_directional_potential)
        out = [None] * len(items)
        solver = (self.potential_solver or 'auto').lower()
        cap = self._potential_batch_cap()
        if solver in ('auto', 'refined') and cap > 1 and len(items) > 1:
            window = cap * 4
            for w0 in range(0, len(items), window):
                win = items[w0:w0 + window]
                handles = self.begin_directional_potentials(
                    [(upd, cid, rid) for cid, rid, upd in win])
                for k, handle in enumerate(handles):
                    out[w0 + k] = finish(handle)
            return out
        depth = 3 if int(np.prod(self.gridsize)) <= 4096 * 4096 else 1
        pending = []
        done = 0
        for cid, rid, upd in items:
            pending.append(self.begin_directional_potential(upd, cid,
                                                            rid))
            if len(pending) >= depth:
                out[done] = finish(pending.pop(0))
                done += 1
        while pending:
            out[done] = finish(pending.pop(0))
            done += 1
        return out

    def _solve_potential(self, conductivity: np.ndarray) -> np.ndarray:
        return self._finish_potential_solve(
            self._begin_potential_solve(conductivity))

    def _begin_potential_solve(self, conductivity: np.ndarray):
        """Dispatch one potential solve. For the refined device solver
        the return value holds UNMATERIALIZED device arrays (the jit
        call is async); the host-side solvers compute synchronously."""
        solver = (self.potential_solver or 'auto').lower()
        if solver == 'auto':
            # the refined device solver matches the f64 direct answer to
            # <=1e-5 relative on hard fields (tests/test_potential.py),
            # so 'auto' always runs on device; 'direct' remains as the
            # host f64 opt-in
            solver = 'refined'
        if solver in ('direct', 'dense'):
            from .potential.direct import solve_potential_direct
            return ('done', solve_potential_direct(conductivity,
                                                   self.track_direction))
        if solver in ('mg', 'multigrid'):
            from .potential import solve_potential_for_direction
            maxiter = self.potential_maxiter if self.potential_maxiter > 0 \
                else 200
            pot, resid = solve_potential_for_direction(
                conductivity, self.track_direction,
                tol=self.potential_tol, maxiter=maxiter)
            return ('done', np.asarray(pot))
        from .potential import solve_potential_refined
        from .potential.boundary import boundary_masks
        bmask, bvals = boundary_masks(self.track_direction,
                                      tuple(self.gridsize))
        maxiter = self.potential_maxiter if self.potential_maxiter > 0 \
            else 60
        pot, resid = solve_potential_refined(
            conductivity, bmask, bvals, tol=float(self.potential_tol),
            maxcycles=maxiter)
        # pot/resid are unmaterialized device arrays: the solve runs
        # while the caller dispatches the next case's prep (pipelining)
        return ('refined', (conductivity, pot, resid))

    def _finish_potential_solve(self, handle) -> np.ndarray:
        return self._finish_potential_solve_pair(handle)[0]

    def _finish_potential_solve_pair(self, handle):
        """(host potential, device potential or None) — see
        :meth:`_finish_directional_potential_pair`."""
        kind, payload = handle
        if kind == 'done':
            return payload, None
        conductivity, pot, resid = payload
        t0 = time.perf_counter()
        rrel = float(resid)  # waits for the device solve
        # structured solver log: the wait for the device solve, its exit
        # residual, and whether the f64 fallback below takes over
        self.timer.records.append({
            'phase': 'potential_finish',
            'seconds': time.perf_counter() - t0,
            'rrel': rrel, 'fallback': rrel > 5e-3})
        # SuperLU-parity safety net: the device solver reports its
        # D^-1-scaled relative residual honestly; normal exits are
        # <= ~1e-4 (6.5e-4 at 67M unknowns). No known field class
        # stalls it anymore (the round-3 fuzz stall was root-caused to
        # the oblique outer island correction and removed —
        # tests/test_potential.py::test_refined_solver_fuzz_vs_oracle
        # pins zero flagged classes), but the rate-free f64 direct
        # solve handles any field, so keep the net: fall back rather
        # than ever hand a bad potential to the track model
        # (mechanism test: test_simulator.py::test_potential_fallback).
        # Known hole in "never": on adversarial dense-speckle fields a
        # residual-INVISIBLE error floor exists — east-strip island
        # LEVELS can sit ~6/1000 off at rrel ~2e-3 (2 of 200 such
        # random speckle solves, docs/DESIGN.md), below this
        # threshold. Raising the threshold false-positives every large
        # grid (67M-unknown exits are 6.5e-4), so the trade is accepted
        # and documented rather than hidden (docs/DESIGN.md).
        if rrel > 5e-3:
            from .potential.direct import (fallback_cost_estimate,
                                           solve_potential_direct)
            unknowns = int(np.prod(self.gridsize))
            est_s, est_gb = fallback_cost_estimate(unknowns)
            cap = int(self.potential_fallback_max_unknowns)
            if cap > 0 and unknowns > cap:
                raise RuntimeError(
                    f'device potential solve stalled (rrel '
                    f'{float(resid):.2e}) on a {self.gridsize[0]}x'
                    f'{self.gridsize[1]} grid, and the f64 direct '
                    f'fallback at {unknowns} unknowns is estimated at '
                    f'~{est_s / 60:.0f} min / ~{est_gb:.0f} GB — and '
                    'measured to FAIL outright at 4096^2 (SuperLU '
                    'int32 fill-in limit; docs/DESIGN.md "fallback '
                    'cost at scale"). Raise Config.'
                    'potential_fallback_max_unknowns to attempt it '
                    "anyway, or set potential_solver='direct' to run "
                    'it deliberately.')
            print(f'device potential solve stalled (rrel '
                  f'{float(resid):.2e}); falling back to the f64 '
                  f'direct solver (estimated ~{est_s:.0f} s / '
                  f'~{est_gb:.1f} GB at {unknowns} unknowns)..',
                  flush=True)
            return solve_potential_direct(np.asarray(conductivity),
                                          self.track_direction), None
        return np.asarray(pot), pot

    def _get_id_string(self, case_id: str, real_id: Optional[int] = None):
        """Artifact id (ssrs/simulator.py:290-298)."""
        out = (f'{case_id}_d{int(self.track_direction % 360)}'
               f'_t{int(self.updraft_threshold * 100)}'
               f'_{self.movement_model}')
        if real_id is not None:
            out += f'_r{int(real_id)}'
        return out

    def _get_potential_fname(self, case_id, real_id, dirname):
        return os.path.join(dirname,
                            f'{self._get_id_string(case_id, real_id)}'
                            '_potential')

    # ---- track simulation -----------------------------------------------

    def _track_params(self) -> TrackParams:
        cap = self.track_max_steps if self.track_max_steps > 0 else \
            self.grid.reference_max_moves()
        return TrackParams(
            grid_shape=self.grid.shape,
            move_dirn=float(self.track_direction),
            nu=float(self.track_stochastic_nu),
            memory_k=int(self.track_dirn_restrict),
            burnin=self.grid.burnin_length(),
            nsteps=cap,
            weight_dtype=str(self.track_weight_precision),
            presence_impl=str(self.track_presence_impl),
            step_impl=str(self.track_step_impl))

    def simulate_tracks(self) -> None:
        """Simulate all tracks for every case/realization
        (ssrs/simulator.py:332-386)."""
        if self._trace_dir:
            jax.profiler.start_trace(self._trace_dir)
        try:
            with self.timer.phase('simulate_tracks',
                                  tracks=int(self.track_count),
                                  cases=len(self.case_ids)):
                self._simulate_tracks_impl()
        finally:
            if self._trace_dir:
                jax.profiler.stop_trace()
        self._dump_phase_timings()

    def _dump_phase_timings(self) -> None:
        """Structured phase log (the reference only prints wall-clock
        strings; SURVEY.md SS5 flags this as a gap)."""
        fpath = os.path.join(self.out_dir, self.run_name,
                             'phase_timings.json')
        try:
            with open(fpath, 'w', encoding='utf-8') as fobj:
                json.dump(self.timer.records, fobj, indent=2, default=str)
        except OSError:
            pass

    def _simulate_tracks_impl(self) -> None:
        print(f'Movement model = {self.movement_model}')
        print(f'Updraft threshold = {self.updraft_threshold} m/s')
        print(f'Movement direction = {self.track_direction} deg (cw)')
        starting_rows, starting_cols = get_starting_indices(
            int(self.track_count), list(self.track_start_region),
            self.track_start_type, tuple(self.region_width_km),
            float(self.resolution), rng=self._rng)
        starts = np.stack([starting_rows, starting_cols],
                          axis=1).astype(np.int32)
        params = self._track_params()
        # reference-format .pkl trajectories are materialized for runs up
        # to Config.track_pkl_budget tracks (chunked recording handles
        # any step cap); larger runs keep only the on-device counts
        record = int(self.track_count) <= int(self.track_pkl_budget)

        if self.movement_model not in ('fluidflow', 'drw'):
            raise ValueError(
                f'movement_model {self.movement_model!r} not '
                "implemented; options: 'fluidflow', 'drw'")

        # enumerate all (case, realization, fields) work items; the
        # potential solves go through _prepare_potentials (batched
        # vmapped groups where they apply, bounded-depth pipelined
        # dispatch otherwise). With Config.fields_device the
        # conductivities stay device-resident (host labeling reads
        # packed bits) and the potential entries are (host, device)
        # pairs so the batched table build skips re-uploads.
        n_fields = len(self.case_ids) * (
            1 + int(self.thermals_realization_count))
        dev_fields = self._device_fields_fit(n_fields)
        work = []
        items = []
        for case_id in self.case_ids:
            updrafts = self.load_updrafts(case_id, apply_threshold=True,
                                          device=dev_fields)
            for real_id, updraft in enumerate(updrafts):
                if self.movement_model == 'fluidflow':
                    items.append((case_id, real_id, updraft))
                else:
                    work.append((case_id, real_id, None, None))
        if items:
            pots = self._prepare_potentials(items, pairs=True)
            work = [(cid, rid, upd, pot)
                    for (cid, rid, upd), pot in zip(items, pots)]

        if not record and len(work) > 1:
            self._simulate_batched(params, starts, work)
            return

        for case_id, real_id, sim_updraft, pot_pair in work:
            sim_potential = pot_pair[0] if pot_pair is not None else None
            id_str = self._get_id_string(case_id, real_id)
            key = case_key(self.sim_seed, case_id, real_id, 'tracks')
            print(f'{id_str}: Simulating {self.track_count} tracks..',
                  end='', flush=True)
            start_time = time.time()
            if record:
                presence, track_list = simulate_tracks_recorded(
                    params, starts, key, updraft=sim_updraft,
                    potential=sim_potential)
                fname = self._get_tracks_fname(case_id, real_id,
                                               self.mode_data_dir)
                with open(f'{fname}.pkl', 'wb') as fobj:
                    pickle.dump(track_list, fobj)
            else:
                presence, steps = self._run_large(
                    params, starts, key, sim_updraft, sim_potential)
            print(f'took {elapsed_str(start_time)}', flush=True)
            fname = self._get_counts_fname(case_id, real_id,
                                           self.mode_data_dir)
            np.save(f'{fname}.npy', np.asarray(presence, dtype=np.int32))

    def _simulate_batched(self, params, starts, work) -> None:
        """All (case, realization) populations run through the
        interleaved multi-case compacting driver
        (ssrs_tpu.agents.simulate_presence_cases_compacting): dead-agent
        compaction, one-dispatch tail, per-case early exit, with the
        host's per-chunk scalar reads overlapped across cases — the
        reference loops these serially through its pool
        (ssrs/simulator.py:348-386)."""
        import jax.numpy as jnp
        from .agents import directional_probs, prepared_weights_batch
        from .agents.simulate import simulate_presence_cases_compacting

        dirp = jnp.asarray(directional_probs(float(self.track_direction)))
        ups, pots, keys = [], [], []
        for case_id, real_id, updraft, pot_pair in work:
            if updraft is None:
                # drw: a zero table never wins over the directional
                # fallback; emulate by an all-ones updraft + flat
                # potential so base weights are uniform*0 -> use dirp
                ups.append(jnp.ones(tuple(self.gridsize), jnp.float32))
                pots.append(jnp.zeros(tuple(self.gridsize), jnp.float32))
            else:
                # device-resident fields feed the table build without a
                # host round trip; host arrays (cached artifacts,
                # fallback results, fields_device=False) upload here
                ups.append(jnp.asarray(updraft, jnp.float32))
                host, dev = pot_pair
                pots.append(dev if dev is not None
                            else jnp.asarray(np.asarray(host, np.float32)))
            keys.append(case_key(self.sim_seed, case_id, real_id,
                                 'tracks'))
        # all C tables in one dispatch; with device-resident fields the
        # build reads the solver's own outputs, while the
        # host-materialized flow re-uploads every potential here
        tables = prepared_weights_batch(
            jnp.stack(ups), jnp.stack(pots),
            jnp.broadcast_to(dirp, (len(work), 9)),
            params.weight_dtype)
        print(f'Simulating {len(work)} cases x {self.track_count} '
              'tracks (batched)..', end='', flush=True)
        start_time = time.time()
        tail = self.track_tail_bucket
        tail = tail if tail == 'auto' else int(tail)
        n_dev = (self.mesh_devices if self.mesh_devices > 0
                 else len(jax.devices()))
        devices = jax.devices()[:n_dev] if n_dev > 1 else None
        presence, steps = simulate_presence_cases_compacting(
            params, tables, np.asarray(starts), keys,
            tail_bucket=tail, devices=devices)
        presence = np.asarray(presence, dtype=np.int32)
        wall = time.time() - start_time
        print(f'took {elapsed_str(start_time)}', flush=True)
        # structured phase record (persisted to phase_timings.json by
        # every caller — simulate_tracks and simulate_direction_sweep
        # both dump at the end): useful steps = presence mass minus the
        # start deposits, as in bench.py
        self.timer.records.append({
            'phase': 'batched_tracks', 'seconds': wall,
            'cases': len(work),
            'useful_steps': int(presence.sum(dtype=np.int64))
            - len(work) * int(self.track_count)})
        for i, (case_id, real_id, _, _) in enumerate(work):
            fname = self._get_counts_fname(case_id, real_id,
                                           self.mode_data_dir)
            np.save(f'{fname}.npy', presence[i])

    def _run_large(self, params, starts, key, updraft, potential):
        """Large-run driver: agent sharding over the device mesh when
        more than one device is available (Config.mesh_devices; 0 = all
        local devices), with dead-agent compaction + the one-dispatch
        tail in BOTH regimes (the sharded driver packs each shard's
        survivors locally and shrinks buckets in lockstep)."""
        n_dev = (self.mesh_devices if self.mesh_devices > 0
                 else len(jax.devices()))
        tail = self.track_tail_bucket
        tail = tail if tail == 'auto' else int(tail)
        if n_dev > 1:
            from .parallel import (make_mesh,
                                   simulate_presence_sharded_compacting)
            mesh = make_mesh(self.mesh_devices)
            return simulate_presence_sharded_compacting(
                params, starts, key, updraft=updraft,
                potential=potential, mesh=mesh, tail_bucket=tail)
        from .agents import simulate_presence_compacting
        return simulate_presence_compacting(
            params, starts, key, updraft=updraft, potential=potential,
            tail_bucket=tail)

    def _get_tracks_fname(self, case_id, real_id, dirname):
        return os.path.join(dirname,
                            f'{self._get_id_string(case_id, real_id)}'
                            '_tracks')

    def _get_counts_fname(self, case_id, real_id, dirname):
        return os.path.join(dirname,
                            f'{self._get_id_string(case_id, real_id)}'
                            '_counts')

    def _get_presence_fname(self, case_id, real_id, dirname):
        return os.path.join(dirname,
                            f'{self._get_id_string(case_id, real_id)}'
                            '_presence')

    def get_presence_counts(self, case_id: str, real_id: int) -> np.ndarray:
        """Presence counts for one realization: the device-side artifact
        when present, else recounted from the tracks pkl."""
        fname = self._get_counts_fname(case_id, real_id,
                                       self.mode_data_dir)
        try:
            return np.load(f'{fname}.npy')
        except FileNotFoundError:
            from .agents import compute_presence_counts
            tname = self._get_tracks_fname(case_id, real_id,
                                           self.mode_data_dir)
            with open(f'{tname}.pkl', 'rb') as fobj:
                tracks = pickle.load(fobj)
            return compute_presence_counts(tracks, self.gridsize)

    # ---- presence maps ---------------------------------------------------

    def compute_presence_map(self, radius: float = 1000.) -> np.ndarray:
        """Summary presence probability over all cases/realizations
        (the computation inside ``plot_presence_map``,
        ssrs/simulator.py:508-546), saved as summary_presence.npy."""
        krad = self._presence_kernel_radius(radius)
        summary_prob = np.zeros(self.gridsize, np.float64)
        for case_id in self.case_ids:
            summary_prob += self._case_presence(case_id, krad)
        return self._finish_summary_presence(summary_prob)

    def get_turbine_presence(self, radius: float = 1000.) -> 'object':
        """Turbine-conflict scores: relative presence density at each
        turbine location (the analysis the reference sketches but leaves
        commented out, ssrs/simulator.py:594-607). Returns a pandas
        DataFrame with per-turbine presence, sorted descending."""
        import pandas as pd
        if self.turbines.dframe is None:
            raise RuntimeError('No turbine data available '
                               '(USWTDB fetch failed or out of bounds)')
        summary = self.compute_presence_map(radius=radius)
        xlocs, ylocs = self.turbines.get_locations()
        xgrid, ygrid = self.get_terrain_grid()
        cols = np.clip(np.searchsorted(xgrid, xlocs), 0,
                       self.gridsize[1] - 1)
        rows = np.clip(np.searchsorted(ygrid, ylocs), 0,
                       self.gridsize[0] - 1)
        scores = summary[rows, cols]
        out = self.turbines.dframe.copy()
        out['presence'] = scores
        return out.sort_values('presence', ascending=False)

    def simulate_direction_sweep(self, wind_dirns) -> List[str]:
        """Uniform-mode wind-direction sweep, batched on device: one
        updraft field, threshold, potential, and agent population per
        direction, all advancing together (BASELINE.json config 2). Only
        valid in uniform mode. Returns the new case ids; artifacts follow
        the standard naming so presence plotting works unchanged."""
        if self.sim_mode.lower() != 'uniform':
            raise ValueError('direction sweep requires uniform mode')
        slope = self.get_terrain_slope().astype(np.float32)
        aspect = self.get_terrain_aspect().astype(np.float32)
        speed = float(self.uniform_windspeed) * np.ones(self.gridsize,
                                                        np.float32)
        # all directions' orographs in one dispatch; with
        # Config.fields_device the thresholded conductivities are
        # computed in the same dispatch and stay device-resident for
        # the solver + weight-table build — only the orograph artifact
        # copies go to the host
        import jax.numpy as jnp
        dev_fields = self.movement_model == 'fluidflow' and \
            self._device_fields_fit(len(wind_dirns))
        oros_dev = jax.vmap(lambda d: compute_orographic_updraft(
            jnp.asarray(speed), d * jnp.ones(self.gridsize, jnp.float32),
            jnp.asarray(slope), jnp.asarray(aspect)))(
                jnp.asarray([float(d) for d in wind_dirns]))
        conds_dev = jax.vmap(lambda o: get_above_threshold_speed(
            o, self.updraft_threshold))(oros_dev) if dev_fields else None
        new_cases = [f's{int(self.uniform_windspeed)}d{int(d)}'
                     for d in wind_dirns]

        def save_orographs():
            oros = np.asarray(oros_dev, np.float32)
            for i, case_id in enumerate(new_cases):
                fname = self._get_orograph_fname(case_id,
                                                 self.mode_data_dir)
                np.save(f'{fname}.npy', oros[i])

        if dev_fields:
            # request the artifact copy asynchronously and materialize
            # it AFTER the potential prep below: the ~C*4N-byte copy
            # streams while the device runs the solves (nothing in
            # the device-resident prep re-reads the .npy artifacts)
            try:
                oros_dev.copy_to_host_async()
            except (AttributeError, NotImplementedError):
                pass
        else:
            # the host flow reloads the artifacts via load_updrafts, so
            # they must exist before the work items are built
            save_orographs()
        self.case_ids = new_cases
        starting_rows, starting_cols = get_starting_indices(
            int(self.track_count), list(self.track_start_region),
            self.track_start_type, tuple(self.region_width_km),
            float(self.resolution), rng=self._rng)
        starts = np.stack([starting_rows, starting_cols],
                          axis=1).astype(np.int32)
        params = self._track_params()
        # shared prep path with _simulate_tracks_impl (the sweep shares
        # one wind speed AND one track direction, so every case hits
        # the same solver executables — batched groups included)
        work = []
        items = []
        for i, case_id in enumerate(new_cases):
            if self.movement_model == 'fluidflow':
                updraft = conds_dev[i] if dev_fields else \
                    self.load_updrafts(case_id, apply_threshold=True)[0]
                items.append((case_id, 0, updraft))
            else:
                work.append((case_id, 0, None, None))
        if items:
            try:
                pots = self._prepare_potentials(items, pairs=True)
            finally:
                # the deferred artifact copy must land even when a
                # solve raises (e.g. the scale-aware fallback cap) —
                # the host flow persisted the orographs before prep
                if dev_fields:
                    save_orographs()
            work = [(cid, rid, upd, pot)
                    for (cid, rid, upd), pot in zip(items, pots)]
        self._simulate_batched(params, starts, work)
        self._dump_phase_timings()
        return new_cases

    # ---- WTK wind interpolation -----------------------------------------

    def get_wtk_locs(self):
        wtk_lons, wtk_lats = self.wtk.get_coordinates()
        return transform_coordinates(self.lonlat_crs, self.projected_crs,
                                     wtk_lons, wtk_lats)

    def _interpolate_wtk_vardata(self, vdata: np.ndarray) -> np.ndarray:
        """Unstructured -> grid interpolation
        (ssrs/simulator.py:765-776)."""
        from scipy.interpolate import griddata
        xgrid, ygrid = self.get_terrain_grid()
        wtk_xlocs, wtk_ylocs = self.get_wtk_locs()
        points = np.array([np.asarray(wtk_xlocs),
                           np.asarray(wtk_ylocs)]).T
        xmesh, ymesh = np.meshgrid(xgrid, ygrid)
        try:
            interp = griddata(points, np.asarray(vdata), (xmesh, ymesh),
                              method=self.wtk_interp_type)
        except Exception:
            # linear/cubic need a triangulable point cloud; tiny regions
            # may contain too few WTK points for one
            interp = None
        nearest = griddata(points, np.asarray(vdata), (xmesh, ymesh),
                           method='nearest')
        if interp is None:
            return nearest
        # grid cells outside the WTK convex hull get nearest-neighbor
        return np.where(np.isnan(interp), nearest, interp)

    def _get_interpolated_wind_conditions(
            self, wspeed, wdirn) -> Tuple[np.ndarray, np.ndarray]:
        """Vector-decompose, interpolate, recompose
        (ssrs/simulator.py:778-792)."""
        wspeed = np.asarray(wspeed, float)
        wdirn = np.asarray(wdirn, float)
        easterly = wspeed * np.sin(np.radians(wdirn))
        northerly = wspeed * np.cos(np.radians(wdirn))
        interp_e = self._interpolate_wtk_vardata(easterly)
        interp_n = self._interpolate_wtk_vardata(northerly)
        interp_speed = np.hypot(interp_e, interp_n)
        interp_dirn = np.mod(np.arctan2(interp_e, interp_n) + 2 * np.pi,
                             2 * np.pi)
        return interp_speed, np.degrees(interp_dirn)

    # ---- seasonal sampling ----------------------------------------------

    def get_seasonal_datetimes(self) -> List[datetime]:
        """Seeded seasonal datetime sampler (ssrs/simulator.py:718-752;
        the reference uses the *unseeded* stdlib random module — here the
        run RNG drives it, fixing the reproducibility gap noted in
        SURVEY.md SS4)."""
        print(f'Seasonal: Requested {self.seasonal_count} counts')
        print(f'Seasonal: Starting Month,Day is {self.seasonal_start}')
        print(f'Seasonal: Ending Month,Day is {self.seasonal_end}')
        print(f'Seasonal: Time of day is {self.seasonal_timeofday}')
        return get_seasonal_datetimes_list(
            self.wtk.years, self.seasonal_start, self.seasonal_end,
            self.seasonal_timeofday, self.seasonal_count,
            tuple(self.lonlat_bounds[0:2]), self._rng)

    # ---- misc ------------------------------------------------------------

    def _get_uniform_id(self):
        return (f's{int(self.uniform_windspeed)}'
                f'd{int(self.uniform_winddirn)}')


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


# in-checkout default of the persistent compile cache (listed in
# .gitignore; tests/conftest.py uses the same directory)
REPO_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    '.jax_cache')


def _enable_compile_cache() -> str:
    """Persist XLA compilations across processes and return the cache
    directory. ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache
    (JAX reads it itself, so no directory is set here); otherwise the
    fixed in-checkout ``.jax_cache``. A fixed path matters: the path is
    part of what the cache is keyed on, so a directory that moves from
    run to run never hits."""
    cache_dir = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if not cache_dir:
        cache_dir = REPO_COMPILE_CACHE
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update('jax_compilation_cache_dir', cache_dir)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1)
    return cache_dir
