"""What the main path needs from its installation: the compile cache
location, the import set of the uniform path, and the GeoTIFF writer that
replaced Pillow."""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from ssrs_tpu.data.geotiff import read_geotiff, write_geotiff
from ssrs_tpu.simulator import REPO_COMPILE_CACHE, _enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keys = ('jax_compilation_cache_dir',
            'jax_persistent_cache_min_entry_size_bytes',
            'jax_persistent_cache_min_compile_time_secs')
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_follows_env_dir(monkeypatch, tmp_path,
                                       restore_cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert _enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: no directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_checkout(monkeypatch,
                                              restore_cache_config):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    assert _enable_compile_cache() == REPO_COMPILE_CACHE
    assert REPO_COMPILE_CACHE == os.path.join(REPO, '.jax_cache')
    assert jax.config.jax_compilation_cache_dir == REPO_COMPILE_CACHE


def test_uniform_main_path_without_optional_packages(tmp_path):
    """import ssrs_tpu and a tiny uniform run (offline synthetic terrain,
    solve, tracks, presence map) with pandas, PIL, matplotlib, requests
    and h5py all unimportable."""
    script = textwrap.dedent(f'''
        import importlib.abc, sys
        BLOCK = {{'pandas', 'PIL', 'matplotlib', 'requests', 'h5py'}}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split('.')[0] in BLOCK:
                    raise ImportError('blocked ' + name)

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        from ssrs_tpu import Config, Simulator
        sim = Simulator(Config(
            run_name='blocked', out_dir={str(tmp_path)!r},
            sim_mode='uniform', sim_seed=1,
            southwest_lonlat=(-106.21, 42.78), region_width_km=(8., 6.),
            resolution=200., track_count=200,
            track_start_region=(1., 7., 1., 2.), track_max_steps=200))
        sim.simulate_tracks()
        p = sim.compute_presence_map()
        assert p.shape == (30, 40) and p.sum() > 0
        assert not [m for m in sys.modules if m.split('.')[0] in BLOCK]
        print('MAIN PATH OK')
    ''')
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, '-c', script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert 'MAIN PATH OK' in out.stdout


@pytest.mark.parametrize('epsg,bounds', [
    (4326, (-106.2, 42.7, -105.4, 43.3)),
    (32613, (390000., 4730000., 450000., 4780000.)),
])
def test_geotiff_writer_round_trip(tmp_path, epsg, bounds):
    rng = np.random.default_rng(epsg)
    data = (1500. + 300. * rng.random((37, 53))).astype(np.float32)
    data[0, 0] = -0.0
    fpath = str(tmp_path / 'dem.tif')
    write_geotiff(fpath, data, bounds, epsg=epsg)
    info = read_geotiff(fpath)
    np.testing.assert_array_equal(info.data.astype(np.float32), data)
    np.testing.assert_allclose(info.bounds, bounds, rtol=0, atol=1e-9)
    assert info.crs_code == f'EPSG:{epsg}'
