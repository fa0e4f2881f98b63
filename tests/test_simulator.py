"""End-to-end Simulator tests, fully offline: synthetic terrain source,
uniform mode, artifact naming parity, presence pipeline, plots."""

import os
import pickle

import numpy as np
import pytest

from ssrs_tpu import Config, Simulator


@pytest.fixture(scope='module')
def sim(tmp_path_factory):
    out = tmp_path_factory.mktemp('runs')
    cfg = Config(
        run_name='wy_test',
        out_dir=str(out),
        sim_mode='uniform',
        sim_seed=11,
        southwest_lonlat=(-106.21, 42.78),
        region_width_km=(12., 10.),
        resolution=200.,
        uniform_winddirn=270.,
        uniform_windspeed=10.,
        track_direction=0.,
        track_count=400,
        track_start_region=(1., 11., 1., 2.),
        track_start_type='random',
        track_max_steps=400,
        movement_model='fluidflow',
    )
    return Simulator(cfg)


def test_ctor_artifacts(sim):
    # grid from region/resolution (ssrs/simulator.py:69-74)
    assert sim.gridsize == (50, 60)
    run_dir = os.path.join(sim.out_dir, 'wy_test')
    assert os.path.isfile(os.path.join(run_dir, 'wy_test.json'))
    assert os.path.isdir(sim.mode_data_dir)
    assert os.path.isdir(sim.mode_fig_dir)
    # uniform case id s<speed>d<dirn> (ssrs/simulator.py:760-763)
    assert sim.case_ids == ['s10d270']
    # orograph artifact naming (ssrs/simulator.py:196-198)
    assert os.path.isfile(os.path.join(sim.mode_data_dir,
                                       's10d270_orograph.npy'))


def test_terrain_layers(sim):
    elev = sim.get_terrain_elevation()
    assert elev.shape == sim.gridsize
    slope = sim.get_terrain_slope()
    aspect = sim.get_terrain_aspect()
    assert slope.shape == sim.gridsize and aspect.shape == sim.gridsize
    assert 0 <= slope.max() <= 90
    x, y = sim.get_terrain_grid()
    assert len(x) == 60 and len(y) == 50
    assert np.isclose(x[1] - x[0], 200.)


def test_updraft_artifact_valid(sim):
    updrafts = sim.load_updrafts('s10d270', apply_threshold=False)
    assert len(updrafts) == 1
    assert updrafts[0].shape == sim.gridsize
    assert updrafts[0].min() >= 0
    thresholded = sim.load_updrafts('s10d270', apply_threshold=True)[0]
    assert (thresholded[updrafts[0] <= 1e-2] == 0).all()


def test_simulate_tracks_and_artifacts(sim):
    sim.simulate_tracks()
    id_str = 's10d270_d0_t75_fluidflow_r0'
    pkl = os.path.join(sim.mode_data_dir, f'{id_str}_tracks.pkl')
    counts = os.path.join(sim.mode_data_dir, f'{id_str}_counts.npy')
    pot = os.path.join(sim.mode_data_dir, f'{id_str}_potential.npy')
    assert os.path.isfile(pkl) and os.path.isfile(counts) \
        and os.path.isfile(pot)
    with open(pkl, 'rb') as fobj:
        tracks = pickle.load(fobj)
    assert len(tracks) == 400
    assert all(t.dtype == np.int16 and t.ndim == 2 and t.shape[1] == 2
               for t in tracks)
    # presence counts equal total trajectory points
    count_map = np.load(counts)
    assert count_map.sum() == sum(len(t) for t in tracks)
    # potential obeys boundary conditions for direction 0
    potential = np.load(pot)
    assert (potential[0, :] == 1000.).all()
    assert (potential[-1, :] == 0.).all()


def test_presence_map(sim):
    summary = sim.compute_presence_map(radius=1000.)
    assert summary.shape == sim.gridsize
    assert np.isclose(summary.max(), 1.0)
    assert os.path.isfile(os.path.join(sim.mode_data_dir,
                                       'summary_presence.npy'))


def test_plots_render(sim):
    sim.plot_terrain_features(plot_turbs=False)
    sim.plot_updrafts(plot_turbs=False)
    sim.plot_updraft_threshold_function()
    sim.plot_directional_potentials(plot_turbs=False)
    sim.plot_simulated_tracks(plot_turbs=False)
    sim.plot_presence_map(plot_turbs=False)
    for f in ('elevation.png', 'slope.png', 'aspect.png',
              'threshold_function.png'):
        assert os.path.isfile(os.path.join(sim.fig_dir, f))
    assert os.path.isfile(os.path.join(
        sim.mode_fig_dir, 's10d270_d0_t75_fluidflow_r0_updraft.png'))
    assert os.path.isfile(os.path.join(
        sim.mode_fig_dir, 's10d270_d0_t75_fluidflow_tracks... png'
        .replace('tracks... png', 'r0_tracks.png')
        .replace('fluidflow_r0', 'fluidflow_r0')))


def test_caching_reuses_artifacts(sim, capsys):
    """Re-running the potential solve must hit the .npy cache
    (ssrs/simulator.py:266-272)."""
    updraft = sim.load_updrafts('s10d270', apply_threshold=True)[0]
    capsys.readouterr()
    sim.get_directional_potential(updraft, 's10d270', 0)
    out = capsys.readouterr().out
    assert 'Found saved potential' in out


def test_drw_mode(tmp_path):
    cfg = Config(
        run_name='drw_test', out_dir=str(tmp_path), sim_mode='uniform',
        sim_seed=3, southwest_lonlat=(-106.21, 42.78),
        region_width_km=(8., 6.), resolution=200., track_count=100,
        track_start_region=(1., 7., 1., 2.), track_max_steps=200,
        movement_model='drw')
    s = Simulator(cfg)
    s.simulate_tracks()
    id_str = 's10d270_d0_t75_drw_r0'
    assert os.path.isfile(os.path.join(
        s.mode_data_dir, f'{id_str}_counts.npy'))


def test_config_json_roundtrip(sim):
    fpath = os.path.join(sim.out_dir, 'wy_test', 'wy_test.json')
    cfg = Config.from_json(fpath)
    assert cfg.run_name == 'wy_test'
    assert cfg.resolution == 200.
    assert tuple(cfg.region_width_km) == (12., 10.)


def test_engine_knobs_roundtrip(tmp_path):
    """The engine knobs survive a JSON round trip, including the
    int-or-'auto' tail bucket (VERDICT r3 item 4)."""
    import json
    fpath = os.path.join(tmp_path, 'knobs.json')
    cfg = Config(track_pkl_budget=123, track_step_impl='xla',
                 track_presence_impl='matmul', track_tail_bucket='auto')
    cfg.to_json(fpath)
    back = Config.from_json(fpath)
    assert back.track_pkl_budget == 123
    assert back.track_step_impl == 'xla'
    assert back.track_presence_impl == 'matmul'
    assert back.track_tail_bucket == 'auto'
    cfg2 = Config(track_tail_bucket=2048)
    fpath2 = os.path.join(tmp_path, 'knobs2.json')
    cfg2.to_json(fpath2)
    assert Config.from_json(fpath2).track_tail_bucket == 2048
    # reference-field serialization is unaffected by the added knobs
    ref = cfg.asdict(reference_fields_only=True)
    assert 'track_pkl_budget' not in ref and 'track_count' in ref


def test_potential_fallback(sim, monkeypatch, capsys):
    """SuperLU-parity safety net: when the device solver reports a
    residual above 5e-3, _solve_potential must discard its answer and
    return the f64 direct solve (simulator.py _solve_potential). No
    known field class trips this anymore (the round-3 fuzz stall was
    root-caused and fixed in potential/lap.py), so force it with a
    stub that returns garbage + a stalled residual."""
    import ssrs_tpu.potential as pot_mod
    from ssrs_tpu.potential.direct import solve_potential_direct

    rng = np.random.default_rng(0)
    cond = rng.random(sim.gridsize).astype(np.float32)
    cond[cond < 0.5] = 0.0
    garbage = np.full(sim.gridsize, 1e6, np.float32)
    monkeypatch.setattr(pot_mod, 'solve_potential_refined',
                        lambda *a, **k: (garbage, 0.5))
    got = sim._solve_potential(cond)
    out = capsys.readouterr().out
    assert 'falling back to the f64 direct solver' in out
    want = solve_potential_direct(cond, sim.track_direction)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_potential_tol_threads_to_refined_solver(sim, monkeypatch):
    """Config.potential_tol must reach the production refined solver
    (it was silently ignored on that path before round 5 — only the
    legacy 'mg' branch honored it)."""
    import ssrs_tpu.potential as pot_mod

    seen = {}

    def fake_solve(cond, bmask, bvals, tol=1e-7, maxcycles=60, **kw):
        seen['tol'] = tol
        return np.zeros(sim.gridsize, np.float32), 1e-9

    monkeypatch.setattr(pot_mod, 'solve_potential_refined', fake_solve)
    monkeypatch.setattr(sim, 'potential_tol', 3e-4)
    rng = np.random.default_rng(0)
    cond = rng.random(sim.gridsize).astype(np.float32)
    sim._solve_potential(cond)
    assert seen['tol'] == 3e-4


def test_potential_fallback_size_cap(sim, monkeypatch):
    """Scale-aware stall policy (VERDICT r3 item 3): above
    Config.potential_fallback_max_unknowns a stall raises with the
    measured cost estimate instead of silently buying an hours-long
    host solve."""
    import pytest

    import ssrs_tpu.potential as pot_mod

    rng = np.random.default_rng(0)
    cond = rng.random(sim.gridsize).astype(np.float32)
    garbage = np.full(sim.gridsize, 1e6, np.float32)
    monkeypatch.setattr(pot_mod, 'solve_potential_refined',
                        lambda *a, **k: (garbage, 0.5))
    monkeypatch.setattr(sim, 'potential_fallback_max_unknowns', 100)
    with pytest.raises(RuntimeError, match='estimated'):
        sim._solve_potential(cond)
    # <= 0 lifts the cap: falls back to the direct solve again
    monkeypatch.setattr(sim, 'potential_fallback_max_unknowns', 0)
    got = sim._solve_potential(cond)
    assert np.isfinite(got).all()


def test_fallback_cost_estimate_monotone():
    """The cost model reproduces its measured anchors and grows
    superlinearly (the SuperLU cost table in potential/direct.py)."""
    from ssrs_tpu.potential.direct import fallback_cost_estimate
    s512, g512 = fallback_cost_estimate(512 * 512)
    assert abs(s512 - 4.9) < 1e-6 and abs(g512 - 0.94) < 1e-6
    s2048, g2048 = fallback_cost_estimate(2048 * 2048)
    assert 250 < s2048 < 500          # measured 364 s
    assert 8 < g2048 < 25             # measured 14.7 GB
    s8192, _ = fallback_cost_estimate(8192 * 8192)
    assert s8192 > 3600               # hours territory: the cap's point


def test_batched_potential_prep_matches_single(sim):
    """begin_directional_potentials (vmapped group solve, incl. the
    pad-to-power-of-two tail) produces the same potentials and
    artifacts as the per-case path, and the second call is a cache
    hit."""
    rng = np.random.default_rng(5)
    shape = tuple(sim.gridsize)
    conds = []
    for i in range(3):
        w = (0.4 + rng.random(shape)).astype(np.float32)
        w[rng.random(shape) < 0.2 + 0.1 * i] = 0.0
        conds.append(w)
    items = [(w, f'batched{i}', 0) for i, w in enumerate(conds)]
    handles = sim.begin_directional_potentials(items)
    assert all(h[0] == 'solve' for h in handles)
    pots_b = [sim.finish_directional_potential(h) for h in handles]
    for i, w in enumerate(conds):
        pot = sim.get_directional_potential(w, f'single{i}', 0)
        assert np.abs(pots_b[i] - pot).max() < 0.05
        fname = sim._get_potential_fname(f'batched{i}', 0,
                                         sim.mode_data_dir)
        assert os.path.isfile(f'{fname}.npy')
    handles = sim.begin_directional_potentials(items)
    assert all(h[0] == 'cached' for h in handles)


def test_potential_batch_cap_policy(sim):
    """Config.potential_batch: 0 = auto = OFF (round-5 reversal:
    sequential pipelined solves measured faster at every grid,
    docs/DESIGN.md), 1 = off, >1 = explicit opt-in
    bounded by the memory envelope."""
    orig = sim.potential_batch
    try:
        sim.potential_batch = 0
        assert sim._potential_batch_cap() == 1
        sim.potential_batch = 1
        assert sim._potential_batch_cap() == 1
        sim.potential_batch = 6
        assert sim._potential_batch_cap() == 6   # 50x60 grid: tiny
    finally:
        sim.potential_batch = orig
