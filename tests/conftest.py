"""Test configuration: run everything on CPU with 8 virtual devices so
multi-device sharding paths are exercised without accelerator hardware
(the strategy SURVEY.md SS4 prescribes).

The exception is ``chip_smoke.py``'s phase 4, which runs the ``gpu``-marked
tests (tests/test_gpu.py) inside its own process on the card: it sets
SSRS_TESTS_ON_DEVICE=1 and JAX keeps the GPU it already initialized."""

import os

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

if not os.environ.get('SSRS_TESTS_ON_DEVICE'):
    os.environ['JAX_PLATFORMS'] = 'cpu'
    flags = os.environ.get('XLA_FLAGS', '')
    if 'xla_force_host_platform_device_count' not in flags:
        os.environ['XLA_FLAGS'] = (
            flags + ' --xla_force_host_platform_device_count=8').strip()
    # a config update wins over the environment as long as no backend
    # has been initialized yet
    jax.config.update('jax_platforms', 'cpu')

    # Persistent compile cache: XLA CPU compiles are ~300 ms per tiny
    # kernel, which dominates test wall-clock without it.
    _CACHE = os.path.join(os.path.dirname(__file__), '..', '.jax_cache')
    jax.config.update('jax_compilation_cache_dir', os.path.abspath(_CACHE))
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)


@pytest.fixture
def gpu():
    """The card, for ``gpu``-marked tests: skips unless JAX's default
    device is an NVIDIA GPU. Decided here at run time, never at import,
    so every xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        pytest.skip(f'needs an NVIDIA GPU (JAX default device: '
                    f'{dev.platform}); run through `python chip_smoke.py`')
    return dev


@pytest.fixture(scope='session')
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope='session')
def synthetic_dem():
    """A deterministic, terrain-like DEM: sum of ridges + smooth bumps."""
    ny, nx = 120, 150
    y = np.linspace(0, 4 * np.pi, ny)[:, None]
    x = np.linspace(0, 5 * np.pi, nx)[None, :]
    z = (400 * np.sin(0.7 * x) * np.cos(0.9 * y)
         + 150 * np.sin(2.3 * x + 0.5) + 100 * np.cos(1.7 * y)
         + 1500)
    return z.astype(np.float64)
