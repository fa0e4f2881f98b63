"""Workshop acceptance suite: replay the reference's five regional case
studies (reference workshop/ssrs_demo.ipynb, configs at cells 9, 23, 32,
45, 57 — fixed seeds 30/20) offline.

Terrain is the synthetic fallback (no egress here) and the snapshot case
uses the LOCAL WTK fixture source, so figure-level parity with the
committed notebook outputs is not assertable; what IS asserted, per case:

- the full pipeline runs end-to-end with the case's exact config values
  (only resolution, step cap, and output dir are scaled down for CPU CI;
  notebooks/workshop_cases.ipynb replays the same cases with figures at
  200 m — set RES=100. there on a GPU host for full size),
- every reference artifact exists with the reference naming scheme,
- the presence mass drifts in the configured movement direction
  (golden *statistics*, robust to the synthetic terrain),
- fixed seed => bit-identical rerun.
"""

import os
import pickle
from dataclasses import replace
from datetime import datetime

import h5py
import numpy as np
import pytest

from ssrs_tpu import Config, Simulator

# CPU-CI scaling: the workshop runs 100 m grids (500x600 etc.); tests run
# the same regions at 400 m so the full 5-case suite stays ~a minute.
RES = 400.
MAX_STEPS = 800
TRACKS = 300

wy_test1 = Config(
    run_name='wy_test', sim_seed=30,
    southwest_lonlat=(-106.21, 42.78), region_width_km=(60., 50.),
    resolution=RES, sim_mode='uniform', uniform_windspeed=10.,
    uniform_winddirn=270., track_direction=0, track_count=TRACKS,
    track_start_region=(5., 55., 1., 2.), updraft_threshold=0.75,
    track_max_steps=MAX_STEPS)

wy_test2 = replace(wy_test1, uniform_windspeed=8., uniform_winddirn=90.,
                   track_direction=-45, track_start_region=(55., 60., 0., 5.))

alt_test1 = replace(wy_test1, run_name='alt_test',
                    southwest_lonlat=(-121.8, 37.55),
                    region_width_km=(40., 40.), sim_mode='snapshot',
                    snapshot_datetime=(2012, 3, 29, 10),
                    track_direction=180,
                    track_start_region=(2., 38., 38., 40.))

apl_test1 = replace(wy_test1, run_name='apl_test',
                    southwest_lonlat=(-79.71, 39.03),
                    region_width_km=(60., 60.), sim_mode='uniform',
                    uniform_windspeed=5., uniform_winddirn=315.,
                    track_direction=0, track_start_region=(5., 55., 0., 2.))

apl_test2 = replace(apl_test1, track_direction=180,
                    track_start_region=(5., 55., 58., 60.), sim_seed=20)


@pytest.fixture(scope='module')
def wtk_2012_h5(tmp_path_factory):
    """LOCAL WTK fixture covering the Altamont region for 2012 (same
    archive shape as the WindToolkit HDF5: coordinates + per-variable
    (time, site) int datasets with scale_factor attrs)."""
    d = tmp_path_factory.mktemp('wtk_ws')
    fpath = str(d / 'wtk_ws_2012.h5')
    rng = np.random.default_rng(11)
    lats = np.linspace(37.3, 38.2, 30)
    lons = np.linspace(-122.1, -121.0, 30)
    lat_g, lon_g = np.meshgrid(lats, lons, indexing='ij')
    coords = np.stack([lat_g.ravel(), lon_g.ravel()], axis=1)
    nsites = coords.shape[0]
    ntimes = 24 * 366
    layers = {'windspeed_100m': 8., 'winddirection_100m': 200.,
              'pressure_100m': 90000., 'temperature_100m': 12.,
              'boundary_layer_height': 800., 'surface_heat_flux': 120.}
    with h5py.File(fpath, 'w') as f:
        f.create_dataset('coordinates', data=coords)
        for name, base in layers.items():
            vals = base * (1. + 0.15 * rng.standard_normal((ntimes, nsites)))
            ds = f.create_dataset(name, data=(vals * 10.).astype('i4'))
            ds.attrs['scale_factor'] = 10.0
    return fpath


def _run_case(cfg, out_dir, monkeypatch=None, wtk_h5=None):
    cfg = replace(cfg, out_dir=str(out_dir))
    if cfg.sim_mode == 'snapshot':
        import ssrs_tpu.data as data_mod
        from ssrs_tpu.data import WTK as RealWTK
        template = wtk_h5.replace('2012', '$YEAR')

        class LocalWTK(RealWTK):
            def __init__(self, source_name, lonlat_bounds, varnames,
                         out_dir, **kw):
                super().__init__('LOCAL', lonlat_bounds, varnames, out_dir,
                                 local_template=template,
                                 local_years=[2012])

        monkeypatch.setattr(data_mod, 'WTK', LocalWTK)
    sim = Simulator(cfg)
    sim.simulate_tracks()
    sim.plot_presence_map()
    return sim


def _case_artifacts(sim, case_id):
    id_str = sim._get_id_string(case_id, 0)
    d = sim.mode_data_dir
    return {
        'orograph': os.path.join(d, f'{case_id}_orograph.npy'),
        'potential': os.path.join(d, f'{id_str}_potential.npy'),
        'tracks': os.path.join(d, f'{id_str}_tracks.pkl'),
        'counts': os.path.join(d, f'{id_str}_counts.npy'),
        'summary': os.path.join(d, 'summary_presence.npy'),
    }


def _presence_centroid(counts):
    p = counts.astype(np.float64)
    p /= p.sum()
    rows = p.sum(axis=1) @ np.arange(p.shape[0])
    cols = p.sum(axis=0) @ np.arange(p.shape[1])
    return rows, cols


def _check_common(sim, case_id):
    art = _case_artifacts(sim, case_id)
    for name, fpath in art.items():
        assert os.path.isfile(fpath), f'missing artifact {name}: {fpath}'
    with open(art['tracks'], 'rb') as f:
        tracks = pickle.load(f)
    assert len(tracks) == TRACKS
    assert all(t.dtype == np.int16 and t.ndim == 2 and t.shape[1] == 2
               for t in tracks)
    counts = np.load(art['counts'])
    assert counts.shape == tuple(sim.gridsize) and counts.sum() >= TRACKS
    return counts, tracks


def test_case1_wy_uniform_north(tmp_path):
    sim = _run_case(wy_test1, tmp_path)
    counts, _ = _check_common(sim, 's10d270')
    r, c = _presence_centroid(counts)
    # northward movement from the southern start strip (y in 1-2 km)
    assert r > (2000. / RES)
    # figure written
    figs = os.listdir(sim.mode_fig_dir)
    assert any('presence' in f for f in figs)


def test_case1_deterministic_rerun(tmp_path):
    sim_a = _run_case(wy_test1, tmp_path / 'a')
    sim_b = _run_case(wy_test1, tmp_path / 'b')
    ca = np.load(_case_artifacts(sim_a, 's10d270')['counts'])
    cb = np.load(_case_artifacts(sim_b, 's10d270')['counts'])
    np.testing.assert_array_equal(ca, cb)


def test_case2_wy_uniform_northwest(tmp_path):
    sim = _run_case(wy_test2, tmp_path)
    counts, _ = _check_common(sim, 's8d90')
    nrow, ncol = sim.gridsize
    r, c = _presence_centroid(counts)
    # -45 deg movement from the southeastern corner: north and west drift
    assert r > (2500. / RES)
    assert c < (57500. / RES)


def test_case3_altamont_snapshot_south(tmp_path, monkeypatch, wtk_2012_h5):
    sim = _run_case(alt_test1, tmp_path, monkeypatch, wtk_2012_h5)
    case_id = datetime(2012, 3, 29, 10).strftime('y%Ym%md%dh%H')
    assert sim.case_ids == [case_id]
    counts, _ = _check_common(sim, case_id)
    nrow, _ = sim.gridsize
    r, c = _presence_centroid(counts)
    # southward movement from the northern start strip (y in 38-40 km)
    assert r < nrow - (2000. / RES)


def test_case4_appalachian_uniform_north(tmp_path):
    sim = _run_case(apl_test1, tmp_path)
    counts, _ = _check_common(sim, 's5d315')
    r, c = _presence_centroid(counts)
    assert r > (2000. / RES)


def test_case5_appalachian_uniform_south(tmp_path):
    sim = _run_case(apl_test2, tmp_path)
    counts, _ = _check_common(sim, 's5d315')
    nrow, _ = sim.gridsize
    r, c = _presence_centroid(counts)
    # seed 20, southward from the northern strip (y in 58-60 km)
    assert r < nrow - (2000. / RES)
