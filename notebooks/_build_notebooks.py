"""Generate and execute the ssrs_tpu demo notebooks.

The reference ships five notebooks (three layer demos in
reference notebooks/{terrain_wy,wtk_wy,ssrs_wy}.ipynb and the two workshop
notebooks in reference workshop/); this builder regenerates their
ssrs_tpu counterparts from code so they stay in sync with the API:

- terrain_demo.ipynb   — terrain layers + turbines for a Wyoming region
- wtk_demo.ipynb       — atmospheric data through the WTK client
- ssrs_modes.ipynb     — the Simulator's three modes end to end
- workshop_cases.ipynb — the five workshop regional case studies

Run ``python notebooks/_build_notebooks.py [--no-exec]`` from the repo
root. Execution is offline-safe (synthetic terrain, LOCAL WTK fixtures)
and forces the CPU backend so it runs anywhere; on a GPU host remove the
platform line in each notebook's first cell.
"""

from __future__ import annotations

import os
import sys

import nbformat as nbf


def nb_new(cells):
    nb = nbf.v4.new_notebook()
    nb.metadata.kernelspec = {
        'display_name': 'Python 3', 'language': 'python', 'name': 'python3'}
    nb.cells = cells
    return nb


def md(src):
    return nbf.v4.new_markdown_cell(src.strip())


def code(src):
    return nbf.v4.new_code_cell(src.strip())


PLATFORM = """
# This demo runs anywhere: pin JAX to CPU so the notebook is portable.
# On a GPU host, delete the next two lines — everything below is the
# same code (the kernels are platform-agnostic JAX).
import jax
jax.config.update('jax_platforms', 'cpu')
%matplotlib inline
"""


# --------------------------------------------------------------------------
# terrain_demo.ipynb
# --------------------------------------------------------------------------

def build_terrain_demo():
    cells = [
        md("""
# Terrain layers with `ssrs_tpu.Terrain`

Counterpart of the reference's `notebooks/terrain_wy.ipynb`: import
terrain layers for a region in Wyoming, reproject them onto the run
grid, and overlay wind-turbine locations.

Differences from the reference worth knowing about:

- the raster stack (GeoTIFF codec, CRS engine, bilinear warp) is
  implemented in-package — no GDAL/rasterio dependency;
- the source chain is 3DEP → SRTM → **synthetic** — the synthetic DEM
  makes the whole walkthrough runnable with zero network (this execution
  is offline, so that is the branch you will see taken);
- derived layers (slope, aspect) are computed on-accelerator with the
  fused Horn-stencil JAX kernels instead of being downloaded.
"""),
        code(PLATFORM + """
import os
import numpy as np
import matplotlib.pyplot as plt

from ssrs_tpu import Terrain, TurbinesUSWTB
from ssrs_tpu.data import (get_raster_in_projected_crs, transform_bounds,
                           transform_coordinates)
from ssrs_tpu.fields import compute_aspect_degrees, compute_slope_degrees
from ssrs_tpu.utils import create_gis_axis, get_extent_from_bounds
"""),
        code("""
# directory where output is saved
output_dir = os.path.join(os.path.abspath(os.path.curdir),
                          'output', 'terrain_demo')
"""),
        md("## 1. Define the region of interest"),
        code("""
proj_crs = 'ESRI:102008'            # projected crs (Albers conic, meters)
lonlat_crs = 'EPSG:4326'            # geographic crs
southwest_lonlat = (-106.14, 42.77) # southwestern corner
region_width_km = (60., 50.)        # region size in km
resolution = 100.                   # grid resolution in meters
"""),
        code("""
# run-grid size implied by the region and resolution
xsize = int(round(region_width_km[0] * 1000. / resolution))
ysize = int(round(region_width_km[1] * 1000. / resolution))
gridsize = (ysize, xsize)
gridsize
"""),
        code("""
# region bounds in the projected and geographic crs
proj_west, proj_south = transform_coordinates(
    lonlat_crs, proj_crs, southwest_lonlat[0], southwest_lonlat[1])
proj_east = float(proj_west[0]) + xsize * resolution
proj_north = float(proj_south[0]) + ysize * resolution
bounds = (float(proj_west[0]), float(proj_south[0]), proj_east, proj_north)
extent = get_extent_from_bounds(bounds)
lonlat_bounds = transform_bounds(bounds, proj_crs, lonlat_crs)
lonlat_bounds
"""),
        md("## 2. Fetch the elevation layer"),
        code("""
# layers the Terrain client knows how to produce
Terrain.valid_layers
"""),
        code("""
# source chain: 3DEP (WMS) -> SRTM (AWS tiles) -> synthetic. Offline,
# the first two raise and the deterministic synthetic DEM is generated
# (same fallback the Simulator uses).
region = Terrain(lonlat_bounds, output_dir)
for candidate in ('DEM', 'SRTM1', 'SYNTHETIC'):
    try:
        region.download(candidate)
        elevation_layer = candidate
        break
    except Exception as exc:
        print(f'{candidate} unavailable ({type(exc).__name__}); '
              'falling back..')
print(f'Elevation source used: {elevation_layer}')
"""),
        code("""
# reproject the cached GeoTIFF onto the run grid (bilinear, in-package)
def get_terrain_layer(lyr):
    fpath = region.get_raster_fpath(lyr)
    return get_raster_in_projected_crs(
        fpath, bounds, gridsize, resolution, proj_crs)

elevation = get_terrain_layer(elevation_layer)
elevation.shape, float(elevation.min()), float(elevation.max())
"""),
        md("""
## 3. Derive slope and aspect on the accelerator

The reference downloads 'Slope Degrees' / 'Aspect Degrees' as separate
3DEP rasters; here they are one fused Horn-stencil kernel evaluation
from the DEM (`ssrs_tpu.fields`), so they exist for any elevation
source — including the offline one.
"""),
        code("""
slope = np.asarray(compute_slope_degrees(elevation, resolution))
aspect = np.asarray(compute_aspect_degrees(elevation, resolution))
"""),
        md("## 4. Wind turbines in the region"),
        code("""
# USWTDB REST query; offline we inject a USWTDB-shaped fixture dataframe
# (the `dataframe=` hook exists for exactly this). Online, drop the
# `dataframe` argument and the client queries the live service.
import pandas as pd

rng = np.random.default_rng(7)
n_turb = 40
fixture = pd.DataFrame({
    't_state': ['WY'] * n_turb,
    'p_name': ['Demo Wind I'] * (n_turb // 2) + ['Demo Wind II'] * (n_turb - n_turb // 2),
    'p_year': rng.choice([2012, 2015, 2019], n_turb),
    't_cap': rng.choice([1500, 2300, 3000], n_turb),
    't_hh': rng.uniform(80., 120., n_turb).round(1),
    't_rd': rng.uniform(90., 140., n_turb).round(1),
    'xlong': rng.uniform(lonlat_bounds[0] + 0.1, lonlat_bounds[2] - 0.1, n_turb),
    'ylat': rng.uniform(lonlat_bounds[1] + 0.1, lonlat_bounds[3] - 0.1, n_turb),
})
turbines = TurbinesUSWTB(bounds, proj_crs, min_hubheight=60.,
                         out_fpath=os.path.join(output_dir, 'turbines.csv'),
                         dataframe=fixture)
turb_xlocs, turb_ylocs = turbines.get_locations()
turbines.print_details()
"""),
        md("## 5. Plot the layers"),
        code("""
layers = {'Elevation (m)': elevation, 'Slope (deg)': slope,
          'Aspect (deg)': aspect}
for title, data in layers.items():
    fig, ax = plt.subplots(figsize=(6, 5))
    cm = ax.imshow(data, cmap='terrain', extent=extent, origin='lower')
    create_gis_axis(fig, ax, cm)
    ax.plot(turb_xlocs, turb_ylocs, '1k', alpha=0.75, markersize=3.)
    ax.set_title(title)
    plt.show()
"""),
    ]
    return nb_new(cells)


# --------------------------------------------------------------------------
# wtk_demo.ipynb
# --------------------------------------------------------------------------

WTK_FIXTURE = """
# Build a LOCAL fixture archive with the WindToolkit HDF5 layout
# (coordinates + per-variable (time, site) int datasets carrying a
# scale_factor attr). The fields are smooth analytic functions of
# lon/lat/time so the interpolation plots below look physical.
import h5py

fixture_dir = os.path.join(output_dir, 'fixtures')
os.makedirs(fixture_dir, exist_ok=True)
fixture_tpl = os.path.join(fixture_dir, 'wtk_demo_$YEAR.h5')
fixture_2014 = fixture_tpl.replace('$YEAR', '2014')

lats = np.linspace(42.7, 43.3, 24)
lons = np.linspace(-106.5, -105.1, 24)
lat_g, lon_g = np.meshgrid(lats, lons, indexing='ij')
coords = np.stack([lat_g.ravel(), lon_g.ravel()], axis=1)
nsites, ntimes = coords.shape[0], 24 * 365

hours = np.arange(ntimes) % 24
diurnal = np.sin((hours[:, None] - 6.) / 24. * 2 * np.pi)
east = (coords[None, :, 1] - lons.min()) / (lons.max() - lons.min())
north = (coords[None, :, 0] - lats.min()) / (lats.max() - lats.min())
layers = {
    'windspeed_100m': 8. + 3. * east + 2. * diurnal,
    'winddirection_100m': 250. + 40. * north,
    'pressure_100m': 82000. - 1500. * north + 300. * diurnal,
    'temperature_100m': 11. + 9. * diurnal - 4. * north,
    'boundary_layer_height': 900. + 600. * np.clip(diurnal, 0., None),
    'surface_heat_flux': 40. + 160. * np.clip(diurnal, 0., None),
}
with h5py.File(fixture_2014, 'w') as f:
    f.create_dataset('coordinates', data=coords)
    for name, vals in layers.items():
        vals = np.broadcast_to(vals, (ntimes, nsites))
        ds = f.create_dataset(name, data=(vals * 100.).astype('i4'))
        ds.attrs['scale_factor'] = 100.0
print(f'fixture archive: {fixture_2014}')
"""


def build_wtk_demo():
    cells = [
        md("""
# Atmospheric data with `ssrs_tpu.WTK`

Counterpart of the reference's `notebooks/wtk_wy.ipynb`: pull
WindToolkit atmospheric layers for a lon/lat-bounded region, look at the
station data for one timestamp, and interpolate the layers onto a
regular grid.

The client speaks to four sources: `AWS` (NREL HSDS over h5pyd — needs
an API key in `.hscfg`), `EAGLE`/`EAGLE_LED` (NREL HPC filesystems), and
`LOCAL` — any h5py-readable archive with the WindToolkit layout. This
execution is offline, so it builds a small LOCAL fixture archive first;
**with connectivity, replace `'LOCAL'` with `'AWS'` and drop the two
`local_*` arguments — every call after the constructor is identical.**
"""),
        code(PLATFORM + """
import os
from datetime import datetime

import numpy as np
import pandas as pd
import matplotlib.pyplot as plt
from scipy.interpolate import griddata

from ssrs_tpu import WTK, WtkSource
from ssrs_tpu.utils import get_extent_from_bounds

output_dir = os.path.join(os.path.abspath(os.path.curdir),
                          'output', 'wtk_demo')
os.makedirs(output_dir, exist_ok=True)
"""),
        code("""
# the registered data sources
WTK.valid_sources
"""),
        code(WTK_FIXTURE),
        code("""
# a source descriptor probes its first archive for the layer list
wtk_source = WtkSource('LOCAL', local_template=fixture_tpl,
                       local_years=[2014])
wtk_source.valid_layers
"""),
        md("## Fetch layers for a region"),
        code("""
wtk_layers = ['windspeed_100m', 'winddirection_100m', 'pressure_100m',
              'temperature_100m']
lonlat_bounds = (-106.411, 42.769, -105.1686, 43.2566)
wtk = WTK('LOCAL', lonlat_bounds, wtk_layers, output_dir,
          local_template=fixture_tpl, local_years=[2014])
"""),
        code("""
# station data for a given datetime (cached to CSV under output_dir,
# with the same artifact naming as the reference)
dtime = datetime(2014, 10, 12, 9)   # (year, month, day, hour)
wtkdf = wtk.get_dataframe_for_this_time(dtime)
wtkdf.head()
"""),
        md("## Interpolate and plot the station layers"),
        code("""
xlocs, ylocs = wtk.get_coordinates()
extent = get_extent_from_bounds(lonlat_bounds)
xmin, xmax, ymin, ymax = extent
num_pts = 100
xmesh, ymesh = np.meshgrid(np.linspace(xmin, xmax, num_pts),
                           np.linspace(ymin, ymax, num_pts))
for this_var in wtk_layers:
    vardata = wtkdf.loc[:, this_var].values.flatten()
    vargrid = griddata(np.stack([xlocs, ylocs], axis=1), vardata,
                       (xmesh, ymesh), method='linear')
    fig, ax = plt.subplots(figsize=(7, 4))
    cm = ax.imshow(vargrid, extent=extent, origin='lower', cmap='viridis',
                   aspect='auto')
    ax.plot(xlocs, ylocs, '.k', markersize=2., alpha=0.5)
    fig.colorbar(cm, ax=ax, label=this_var)
    ax.set_xlabel('Longitude'); ax.set_ylabel('Latitude')
    ax.set_title(f'{this_var} at {dtime}')
    plt.show()
"""),
        md("""
## Notes for online use

- `WTK('AWS', ...)` needs an NREL developer API key: call
  `ssrs_tpu.data.wtksource.create_hscfg_file(api_key, '.hscfg')` once.
- The `Simulator` drives this exact client in its `snapshot` and
  `seasonal` modes; `Config(wtk_source='LOCAL', wtk_local_template=...,
  wtk_local_years=(...,))` points a whole simulation at fixture
  archives — see `ssrs_modes.ipynb`.
"""),
    ]
    return nb_new(cells)


# --------------------------------------------------------------------------
# ssrs_modes.ipynb
# --------------------------------------------------------------------------

def build_modes_demo():
    cells = [
        md("""
# The `Simulator`: uniform, snapshot, and seasonal modes

Counterpart of the reference's `notebooks/ssrs_wy.ipynb` — one
`Simulator` object per mode, same `Config` surface, same artifact and
figure outputs. The engine underneath is the JAX device engine: fused
updraft kernels, the on-device multigrid potential solver, and the
lockstep vectorized track simulation (100k+ simultaneous agents on one
chip; a CPU run like this one uses the identical code path).

Offline notes: terrain falls back to the deterministic synthetic DEM,
turbines degrade to none, and the WTK-driven modes read a LOCAL fixture
archive (swap `wtk_source` to `'AWS'` online).
"""),
        code(PLATFORM + """
import os
from dataclasses import replace

import numpy as np
import matplotlib.pyplot as plt

from ssrs_tpu import Config, Simulator

output_dir = os.path.join(os.path.abspath(os.path.curdir),
                          'output', 'ssrs_modes')
"""),
        md("""
## Uniform mode

One wind speed/direction everywhere; the updraft field is purely
orographic.
"""),
        code("""
config_uniform = Config(
    run_name='modes_wy',
    out_dir=output_dir,
    sim_seed=30,
    # terrain
    southwest_lonlat=(-106.21, 42.78),
    region_width_km=(60., 50.),
    resolution=250.,          # demo resolution; production runs use 100 m
    # simulation
    sim_mode='uniform',
    uniform_winddirn=270.,
    uniform_windspeed=10.,
    track_direction=0.,
    track_count=1000,
    track_start_region=(5., 55., 1., 2.),
    track_max_steps=2000,
)
sim = Simulator(config_uniform)
sim.simulate_tracks()
"""),
        code("""
sim.plot_terrain_elevation(show=True)
sim.plot_updrafts(show=True)
sim.plot_simulated_tracks(show=True)
sim.plot_presence_map(show=True)
"""),
        md("""
## Snapshot mode

Wind conditions come from the WindToolkit at one datetime; updrafts are
computed from the interpolated wind field. Offline this reads a LOCAL
fixture archive — online, set `wtk_source='AWS'` and drop the
`wtk_local_*` fields.
"""),
        code("""
# build the fixture archive the snapshot will read (WindToolkit layout)
import h5py

fixture_dir = os.path.join(output_dir, 'fixtures')
os.makedirs(fixture_dir, exist_ok=True)
fixture_tpl = os.path.join(fixture_dir, 'wtk_modes_$YEAR.h5')
lats = np.linspace(42.7, 43.3, 24)
lons = np.linspace(-106.5, -105.1, 24)
lat_g, lon_g = np.meshgrid(lats, lons, indexing='ij')
coords = np.stack([lat_g.ravel(), lon_g.ravel()], axis=1)
nsites, ntimes = coords.shape[0], 24 * 366
hours = np.arange(ntimes) % 24
diurnal = np.sin((hours[:, None] - 6.) / 24. * 2 * np.pi)
north = (coords[None, :, 0] - lats.min()) / (lats.max() - lats.min())
layers = {
    'windspeed_100m': 9. + 2.5 * diurnal + 2. * north,
    'winddirection_100m': 260. + 30. * north,
    'pressure_100m': 82000. - 1200. * north,
    'temperature_100m': 10. + 8. * diurnal,
    'boundary_layer_height': 900. + 700. * np.clip(diurnal, 0., None),
    'surface_heat_flux': 50. + 150. * np.clip(diurnal, 0., None),
}
for year in (2012, 2014):
    with h5py.File(fixture_tpl.replace('$YEAR', str(year)), 'w') as f:
        f.create_dataset('coordinates', data=coords)
        for name, vals in layers.items():
            vals = np.broadcast_to(vals, (ntimes, nsites))
            ds = f.create_dataset(name, data=(vals * 100.).astype('i4'))
            ds.attrs['scale_factor'] = 100.0
"""),
        code("""
config_snapshot = replace(
    config_uniform,
    sim_mode='snapshot',
    snapshot_datetime=(2014, 12, 1, 15),
    wtk_source='LOCAL',
    wtk_local_template=fixture_tpl,
    wtk_local_years=(2012, 2014),
)
sim = Simulator(config_snapshot)
sim.simulate_tracks()
sim.plot_wtk_layers(show=True)
sim.plot_simulated_tracks(show=True)
sim.plot_presence_map(show=True)
"""),
        md("""
## Seasonal mode

A season is a distribution over datetimes (sampled between sunrise and
sunset via the in-package NOAA solar calculator); each sampled datetime
becomes a snapshot case, and the presence maps are averaged. On the device the
cases advance **batched together** (`vmap` over the case axis) instead
of serially.
"""),
        code("""
config_seasonal = replace(
    config_snapshot,
    sim_mode='seasonal',
    seasonal_start=(3, 20),
    seasonal_end=(5, 15),
    seasonal_timeofday='daytime',
    seasonal_count=2,         # demo count; production sweeps use 8+
    track_count=500,
)
sim = Simulator(config_seasonal)
sim.simulate_tracks()
sim.plot_presence_map(show=True)
"""),
        md("""
## What was produced

Every run wrote the reference's artifact set under
`output/ssrs_modes/modes_wy/`: per-case `*_potential.npy`,
`*_tracks.pkl`, `*_counts.npy`, the run config JSON, `summary_presence.npy`,
and the figures shown above — byte-compatible naming with the reference
so downstream tooling can consume either.
"""),
    ]
    return nb_new(cells)


# --------------------------------------------------------------------------
# workshop_cases.ipynb
# --------------------------------------------------------------------------

def build_workshop_cases():
    cells = [
        md("""
# Workshop case studies

Counterpart of the reference's `workshop/ssrs_demo.ipynb`: the five
regional case studies (two Wyoming uniform-mode runs, an Altamont Pass
snapshot run, and two Appalachian uniform-mode runs) with the workshop's
exact configuration values and fixed seeds (30, and 20 for the final
case).

This executed copy runs offline — synthetic terrain, LOCAL WTK fixture,
no USWTDB — at 200 m resolution so it executes in minutes on CPU
(the workshop used 100 m grids with live 3DEP terrain; change
`RES = 100.` on a GPU host for the full-size replay). The
same five cases run as assertions in `tests/test_workshop_cases.py`.
"""),
        code(PLATFORM + """
import os
from dataclasses import replace

import numpy as np
import matplotlib.pyplot as plt

from ssrs_tpu import Config, Simulator

output_dir = os.path.join(os.path.abspath(os.path.curdir),
                          'output', 'workshop')
RES = 200.          # demo resolution (workshop: 100.)
MAX_STEPS = 2000    # step cap for the demo replay
"""),
        md("""
## Test 1: Wyoming region

Westerly 10 m/s uniform wind, northward movement from a southern entry
strip.
"""),
        code("""
wy_test1 = Config(
    run_name='wy_workshop',
    out_dir=output_dir,
    sim_seed=30,
    southwest_lonlat=(-106.21, 42.78),
    region_width_km=(60., 50.),
    resolution=RES,
    sim_mode='uniform',
    uniform_windspeed=10.,
    uniform_winddirn=270.,
    track_direction=0,
    track_count=1000,
    track_start_region=(5., 55., 1., 2.),
    updraft_threshold=0.75,
    track_max_steps=MAX_STEPS,
)
print(wy_test1)
"""),
        code("""
wy_sim1 = Simulator(wy_test1)
wy_sim1.plot_terrain_elevation(show=True)
"""),
        code("""
# updrafts before and after the usability threshold
wy_sim1.plot_updrafts(apply_threshold=False, show=True)
wy_sim1.plot_updraft_threshold_function(show=True)
wy_sim1.plot_updrafts(apply_threshold=True, show=True)
"""),
        code("""
wy_sim1.simulate_tracks()
wy_sim1.plot_simulated_tracks(show=True)
wy_sim1.plot_presence_map(show=True)
"""),
        md("""
## Test 2: Wyoming region, reversed flow

Easterly 8 m/s wind, northwest (−45°) movement from a southeastern
entry strip.
"""),
        code("""
wy_test2 = replace(
    wy_test1,
    uniform_windspeed=8.,
    uniform_winddirn=90.,
    track_direction=-45,
    track_start_region=(55., 60., 0., 5.),
)
wy_sim2 = Simulator(wy_test2)
wy_sim2.simulate_tracks()
wy_sim2.plot_updrafts(show=True)
wy_sim2.plot_simulated_tracks(show=True)
wy_sim2.plot_presence_map(show=True)
"""),
        md("""
## Test 3: Altamont Pass, California (snapshot mode)

WindToolkit conditions at 2012-03-29 10:00, southward movement from a
northern entry strip. Offline, the WTK reads a LOCAL fixture archive
shaped like the real one (online: `wtk_source='AWS'`).
"""),
        code("""
import h5py

fixture_dir = os.path.join(output_dir, 'fixtures')
os.makedirs(fixture_dir, exist_ok=True)
fixture_tpl = os.path.join(fixture_dir, 'wtk_alt_$YEAR.h5')
rng = np.random.default_rng(11)
lats = np.linspace(37.3, 38.2, 30)
lons = np.linspace(-122.1, -121.0, 30)
lat_g, lon_g = np.meshgrid(lats, lons, indexing='ij')
coords = np.stack([lat_g.ravel(), lon_g.ravel()], axis=1)
nsites, ntimes = coords.shape[0], 24 * 366
base = {'windspeed_100m': 8., 'winddirection_100m': 200.,
        'pressure_100m': 90000., 'temperature_100m': 12.,
        'boundary_layer_height': 800., 'surface_heat_flux': 120.}
with h5py.File(fixture_tpl.replace('$YEAR', '2012'), 'w') as f:
    f.create_dataset('coordinates', data=coords)
    for name, b in base.items():
        vals = b * (1. + 0.15 * rng.standard_normal((ntimes, nsites)))
        ds = f.create_dataset(name, data=(vals * 10.).astype('i4'))
        ds.attrs['scale_factor'] = 10.0
"""),
        code("""
alt_test1 = replace(
    wy_test1,
    run_name='alt_workshop',
    southwest_lonlat=(-121.8, 37.55),
    region_width_km=(40., 40.),
    sim_mode='snapshot',
    snapshot_datetime=(2012, 3, 29, 10),
    track_direction=180,
    track_start_region=(2., 38., 38., 40.),
    wtk_source='LOCAL',
    wtk_local_template=fixture_tpl,
    wtk_local_years=(2012,),
)
alt_sim1 = Simulator(alt_test1)
alt_sim1.plot_terrain_elevation(show=True)
alt_sim1.plot_wtk_layers(show=True)
alt_sim1.plot_updrafts(show=True)
"""),
        code("""
alt_sim1.simulate_tracks()
alt_sim1.plot_simulated_tracks(show=True)
alt_sim1.plot_presence_map(show=True)
"""),
        md("""
## Test 4: Appalachian region

Northwesterly 5 m/s wind over ridge-and-valley terrain, northward
movement.
"""),
        code("""
apl_test1 = replace(
    wy_test1,
    run_name='apl_workshop',
    southwest_lonlat=(-79.71, 39.03),
    region_width_km=(60., 60.),
    sim_mode='uniform',
    uniform_windspeed=5.,
    uniform_winddirn=315.,
    track_direction=0,
    track_start_region=(5., 55., 0., 2.),
)
apl_sim1 = Simulator(apl_test1)
apl_sim1.simulate_tracks()
apl_sim1.plot_terrain_elevation(show=True)
apl_sim1.plot_updrafts(show=True)
apl_sim1.plot_simulated_tracks(show=True)
apl_sim1.plot_presence_map(show=True)
"""),
        md("""
## Test 5: Appalachian region, southward

Same region and wind, reversed movement direction from a northern entry
strip, seed 20.
"""),
        code("""
apl_test2 = replace(
    apl_test1,
    track_direction=180,
    track_start_region=(5., 55., 58., 60.),
    sim_seed=20,
)
apl_sim2 = Simulator(apl_test2)
apl_sim2.simulate_tracks()
apl_sim2.plot_updrafts(show=True)
apl_sim2.plot_simulated_tracks(show=True)
apl_sim2.plot_presence_map(show=True)
"""),
        md("""
## Reproducibility

Each case above is seeded; rerunning this notebook regenerates
bit-identical presence counts (asserted per case in
`tests/test_workshop_cases.py`, which replays these five configurations
with scaled-down grids as part of the CI suite).
"""),
    ]
    return nb_new(cells)


BUILDERS = {
    'terrain_demo.ipynb': build_terrain_demo,
    'wtk_demo.ipynb': build_wtk_demo,
    'ssrs_modes.ipynb': build_modes_demo,
    'workshop_cases.ipynb': build_workshop_cases,
}


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    execute = '--no-exec' not in sys.argv
    only = [a for a in sys.argv[1:] if not a.startswith('--')]
    for fname, builder in BUILDERS.items():
        if only and fname not in only:
            continue
        nb = builder()
        path = os.path.join(here, fname)
        if execute:
            from nbclient import NotebookClient
            print(f'executing {fname} ..', flush=True)
            client = NotebookClient(nb, timeout=1800,
                                    resources={'metadata': {'path': here}})
            client.execute()
        nbf.write(nb, path)
        print(f'wrote {path}')


if __name__ == '__main__':
    main()
