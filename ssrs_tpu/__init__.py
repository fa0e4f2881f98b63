"""ssrs_tpu — a JAX stochastic soaring-raptor simulation framework.

A from-scratch JAX/XLA re-design of the capabilities of NREL/SSRS
(reference layer map in SURVEY.md): orographic/thermal updraft field
kernels, a directional-potential solver (device multigrid + host direct),
a lockstep vectorized agent movement model scaling to 100k+ simultaneous
tracks on an accelerator, presence-density accumulation on device, and the
Config/Simulator user API with artifact-compatible outputs.

Public surface mirrors the reference package exports
(reference ssrs/__init__.py:1-10) plus the engine's own subpackages.
"""

from .config import Config
from .simulator import Simulator
from .core import Grid
from .data import (SRTM, WMS, WTK, Terrain, ThreeDEP, TurbinesUSWTB,
                   WtkSource, get_raster_in_projected_crs,
                   transform_bounds, transform_coordinates,
                   get_utm_string)
from .fields import (compute_aspect_degrees, compute_orographic_updraft,
                     compute_slope_degrees, compute_thermals,
                     deardoff_velocity_function,
                     compute_potential_temperature,
                     compute_thermal_updraft, get_above_threshold_speed)

__version__ = '0.1.0'

__all__ = [
    'Config', 'Simulator', 'Grid', 'SRTM', 'WMS', 'WTK', 'Terrain',
    'ThreeDEP', 'TurbinesUSWTB', 'WtkSource',
    'get_raster_in_projected_crs', 'transform_bounds',
    'transform_coordinates', 'get_utm_string', 'compute_aspect_degrees',
    'compute_orographic_updraft', 'compute_slope_degrees',
    'compute_thermals', 'deardoff_velocity_function',
    'compute_potential_temperature', 'compute_thermal_updraft',
    'get_above_threshold_speed',
]
