"""Card-only tests: what only the GPU's compiler can show — whether XLA
contracts the double-single error-free transforms, whether the int8
one-hot matmul histogram is exact, and the XLA step and refined solver
as compiled for the card. Off the card they skip; ``python chip_smoke.py``
runs them on the card in its phase 4."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.gpu


def _run(fn, *args, **kw):
    checks = cs.Checks()
    fn(checks, *args, **kw)
    assert not checks.failed, checks.failed


def test_ds_transforms_exact_on_gpu(gpu):
    _run(cs.check_ds, n=200_000, seed=1)


@pytest.mark.parametrize('shape', [(500, 600), (1200, 1400)])
def test_presence_matmul_equals_scatter_on_gpu(gpu, shape):
    _run(cs.check_presence_paths, shape, 100_000, seed=2)


def test_terrain_kernels_on_gpu(gpu):
    _run(cs.check_terrain, (250, 300))


@pytest.mark.parametrize('dirn', [0., 90., 270.])
def test_refined_solve_matches_superlu_on_gpu(gpu, dirn):
    _run(cs.check_solve, cs.wy_conductivity((240, 300), dirn=dirn + 90.),
         dirn)


def test_simulator_presence_paths_bit_identical_on_gpu(gpu, tmp_path):
    """A whole uniform run gives bit-identical counts with the matmul and
    the scatter presence paths (integer sums in any order). The potential
    comes from the host f64 solve: the device solve's float sums are not
    bit-reproducible from run to run on the GPU, and a different last bit
    in the potential samples different tracks."""
    from ssrs_tpu import Config, Simulator
    counts = []
    for impl in ('matmul', 'scatter'):
        sim = Simulator(Config(
            run_name=impl, out_dir=str(tmp_path), sim_mode='uniform',
            sim_seed=3, southwest_lonlat=(-106.21, 42.78),
            region_width_km=(20., 16.), resolution=100., track_count=20_000,
            track_start_region=(1., 19., 1., 2.), potential_solver='direct',
            track_presence_impl=impl))
        sim.simulate_tracks()
        sid = sim._get_id_string(sim.case_ids[0], 0)
        counts.append(np.load(os.path.join(sim.mode_data_dir,
                                           f'{sid}_counts.npy')))
    assert counts[0].sum() >= 20_000
    np.testing.assert_array_equal(counts[0], counts[1])
