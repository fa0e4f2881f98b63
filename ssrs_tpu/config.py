"""Run configuration for the SSRS JAX engine.

Mirrors the reference's flat ``Config`` dataclass field-for-field
(reference: ``ssrs/config.py:9-91``) so run JSONs and ``dataclasses.replace``
composition remain compatible, and adds engine-specific knobs in a way that
keeps the reference defaults byte-identical when serialized with
``reference_fields_only=True``.

Known reference quirks kept for compatibility (types are annotations only in
the reference; we keep the *values* but use correct annotations):
- ``track_count`` was annotated ``str`` with default ``1000``
- ``thermals_realization_count`` was annotated ``bool`` with default ``0``
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field, fields
from typing import Tuple


@dataclass
class Config:
    """Configuration parameters for SSRS simulation """

    # general parameters for the SSRS simulation
    run_name: str = 'default'  # name of this run, determines directory names
    out_dir: str = field(
        default_factory=lambda: os.path.join(
            os.path.abspath(os.path.curdir), 'output'))
    max_cores: int = 8  # retained for config parity; the engine ignores it
    sim_seed: int = -1  # random number seed
    sim_mode: str = 'uniform'  # snapshot, seasonal, uniform
    print_verbose: bool = False  # if want to print verbose

    # parameters defining the terrain
    southwest_lonlat: Tuple[float, float] = (-106.21, 42.78)
    projected_crs: str = 'ESRI:102008'  # ESRI, EPSG, PROJ4 or WKT string
    region_width_km: Tuple[float, float] = (60., 50.)
    resolution: float = 100.  # desired terrain resolution (meters)

    # parameters for uniform mode
    uniform_winddirn: float = 270.  # northerly = 0., easterly = 90, westerly = 270
    uniform_windspeed: float = 10.  # uniform wind speed in m/s

    # parameters for snapshot mode
    snapshot_datetime: Tuple[int, int, int, int] = (2010, 6, 17, 13)

    # parameters for seasonal mode
    seasonal_start: Tuple[int, int] = (3, 20)  # start of season (month, day)
    seasonal_end: Tuple[int, int] = (5, 15)  # end of season (month, day)
    seasonal_timeofday: str = 'daytime'  # morning, afternoon, evening, daytime
    seasonal_count: int = 8  # number of seasonal updraft computations

    # downloading data from WTK
    wtk_source: str = 'AWS'  # 'EAGLE', 'AWS', 'EAGLE_LED'
    wtk_orographic_height: int = 100  # WTK wind conditions at this height
    wtk_thermal_height: int = 100  # WTK pressure, temperature, at this height
    wtk_interp_type: str = 'linear'  # 'nearest' 'linear' 'cubic'

    # parameters defining the updraft calculation
    thermals_realization_count: int = 0  # number of realizations of thermals
    updraft_threshold: float = 0.75  # only use updrafts higher than this
    movement_model: str = 'fluidflow'  # fluidflow, drw

    # parameters for simulating tracks
    track_direction: float = 0.  # movement direction measured clockwise from north
    track_count: int = 1000  # number of simulated eagle tracks
    track_start_region: Tuple[float, float, float, float] = (5., 55., 1., 2.)
    track_start_type: str = 'random'  # structured, random
    track_stochastic_nu: float = 1.  # scaling of move probs, 0 = random walk
    track_dirn_restrict: int = 1  # restrict within 45 deg of previous # moves

    # turbine related
    turbine_minimum_hubheight: float = 50.  # for select turbine locations
    turbine_mrkr_size: float = 3.

    # plotting related
    fig_height: float = 6.
    fig_dpi: int = 200  # increase this to get finer plots

    # ---- engine knobs (absent from the reference) ----
    # maximum steps per track; <=0 means the reference's cap
    # (nrow/2)*(ncol/2) (ssrs/movmodel.py:277), which is usually far
    # beyond the empirical track length.
    track_max_steps: int = 0
    # presence accumulation inside the simulation scan ('scan-scatter') or
    # chunked device bincount ('chunked')
    presence_accumulator: str = 'scan-scatter'
    # iterative potential-solver controls
    potential_solver: str = 'auto'  # auto, bicgstab, multigrid, dense
    # scaled-residual convergence target for the device potential
    # solvers (refined and mg paths both honor it). 1e-7 is the
    # measured deep-convergence setting behind the f64-oracle parity
    # claims (solves typically exit at the ~2e-6 f32 floor via the
    # stall guards anyway); loosening to 1e-5..1e-4 trades potential
    # accuracy for prep wall on sweep workloads — see docs/DESIGN.md
    # for the measured trade before relying on it
    potential_tol: float = 1e-7
    potential_maxiter: int = 0  # <=0 chooses a grid-dependent default
    # stall-fallback size cap: if the device solver stalls (rrel >
    # 5e-3, never observed on realistic fields) the f64 SuperLU
    # fallback runs only when nrow*ncol <= this (measured cost: ~6 min
    # / 15 GB at 2048^2, ~n^3 wall growth; at 4096^2 SuperLU's int32
    # fill-in limit makes the factorization FAIL outright —
    # docs/DESIGN.md "fallback cost at scale"); larger grids raise
    # with the cost estimate instead of silently attempting it. <= 0
    # lifts the cap.
    potential_fallback_max_unknowns: int = 8_000_000
    # multi-case potential solves: 0 = auto, which resolves to OFF —
    # sequential pipelined solves measured faster at every grid on the
    # previous accelerator (not re-measured on the GPU), and batched
    # convergence is composition-fragile on ill-conditioned fields:
    # 3e-7 solo cases exit at 3e-3 in batches >= 4 (docs/DESIGN.md
    # "the batched-solve reversal"). 1 = off explicitly;
    # >1 = run vmapped programs of up to this many cases (memory-capped)
    potential_batch: int = 0
    # device mesh: number of devices to shard agents over (0 = all local)
    mesh_devices: int = 0
    # keep multi-case prep fields (thresholded conductivities, solved
    # potentials) RESIDENT on device from the updraft dispatch through
    # the weight-table build: host island labeling reads only a packed
    # cond>0 bitmask (N/8 bytes vs 4N) and the weight tables consume
    # the solver's device outputs directly, so the only full-field
    # device-to-host transfers left are the artifact .npy copies. False
    # restores the host-materialized flow (A/B + debugging escape);
    # artifacts and results are identical either way
    # (tests/test_simulator.py::test_device_resident_fields_match_host)
    fields_device: bool = True
    # storage dtype of the per-cell move-weight table: 'auto' (default)
    # resolves by agents/simulate.resolve_weight_dtype; 'bfloat16'
    # (~0.4% relative weight quantization that the presence statistics
    # absorb) and 'float32' override.
    track_weight_precision: str = 'auto'
    # LOCAL WTK source (offline fixtures): a .h5 path template containing
    # '$YEAR' plus the years it covers; only read when wtk_source='LOCAL'
    wtk_local_template: str = ''
    wtk_local_years: Tuple[int, ...] = ()
    # materialize reference-format ``_tracks.pkl`` trajectories for runs
    # with track_count <= this budget; larger runs keep only the
    # on-device presence counts (``_counts.npy``)
    track_pkl_budget: int = 10_000
    # step engine passthrough to the agent scan: 'auto' or 'xla', both
    # the XLA step (ssrs_tpu.agents.simulate module docstring)
    track_step_impl: str = 'auto'
    # presence accumulation inside the step: 'auto'
    # (agents/simulate.resolve_presence_impl), 'matmul', 'scatter'
    track_presence_impl: str = 'auto'
    # compacting-driver tail switch: 0 = one-dispatch tail at the
    # minimum bucket (deterministic default), a positive int = switch at
    # that bucket, -1 = never, 'auto' = self-tuned from measured
    # dispatch cost (throughput mode; NOT run-to-run deterministic)
    track_tail_bucket: object = 0

    # class-level constant (not a dataclass field; matches reference where
    # turbine_mrkr_styles carries no annotation, ssrs/config.py:61)
    turbine_mrkr_styles = ('1k', '2k', '3k', '4k',
                           '+k', 'xk', '*k', '.k', 'ok')

    # names of the fields the reference Config carries, in reference order
    REFERENCE_FIELDS = (
        'run_name', 'out_dir', 'max_cores', 'sim_seed', 'sim_mode',
        'print_verbose', 'southwest_lonlat', 'projected_crs',
        'region_width_km', 'resolution', 'uniform_winddirn',
        'uniform_windspeed', 'snapshot_datetime', 'seasonal_start',
        'seasonal_end', 'seasonal_timeofday', 'seasonal_count', 'wtk_source',
        'wtk_orographic_height', 'wtk_thermal_height', 'wtk_interp_type',
        'thermals_realization_count', 'updraft_threshold', 'movement_model',
        'track_direction', 'track_count', 'track_start_region',
        'track_start_type', 'track_stochastic_nu', 'track_dirn_restrict',
        'turbine_minimum_hubheight', 'turbine_mrkr_size', 'fig_height',
        'fig_dpi',
    )

    def asdict(self, reference_fields_only: bool = False) -> dict:
        """Dataclass contents as a plain dict."""
        out = asdict(self)
        if reference_fields_only:
            out = {k: out[k] for k in self.REFERENCE_FIELDS}
        return out

    def to_json(self, fpath: str, reference_fields_only: bool = False) -> None:
        """Dump config as JSON (matches reference run-JSON dump,
        ssrs/simulator.py:63-67)."""
        with open(fpath, 'w', encoding='utf-8') as cfile:
            json.dump(self.asdict(reference_fields_only), cfile,
                      ensure_ascii=False, indent=2)

    @classmethod
    def from_json(cls, fpath: str) -> 'Config':
        """Load a config from a run JSON, ignoring unknown keys and
        coercing sequences back to tuples."""
        with open(fpath, 'r', encoding='utf-8') as cfile:
            raw = json.load(cfile)
        valid = {f.name for f in fields(cls)}
        kwargs = {}
        for key, val in raw.items():
            if key not in valid:
                continue
            kwargs[key] = tuple(val) if isinstance(val, list) else val
        return cls(**kwargs)

    def __str__(self):
        groups = {
            0: '\n:::: General settings\n',
            6: '\n:::: Terrain settings\n',
            10: '\n:::: Uniform mode\n',
            12: '\n:::: Snapshot mode\n',
            13: '\n:::: Seasonal mode\n',
            17: '\n:::: WindToolKit settings\n',
            21: '\n:::: Updraft computation\n',
            24: '\n:::: Simulating tracks\n',
            30: '\n:::: Plotting and wind turbines\n',
            34: '\n:::: Engine settings\n',
        }
        out_str = (self.__doc__ or '') + '\n'
        for i, fld in enumerate(fields(self)):
            if i in groups:
                out_str += groups[i]
            out_str += f'{fld.name} = {getattr(self, fld.name)}\n'
        return out_str
