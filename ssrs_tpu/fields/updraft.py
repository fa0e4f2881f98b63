"""Orographic updraft and usable-updraft threshold device kernels.

Reference semantics:
- ``compute_orographic_updraft`` (ssrs/layers.py:11-22):
  w = max(min_val, speed * sin(slope) * max(0, cos(aspect - dirn))).
- ``get_above_threshold_speed`` (ssrs/layers.py:171-185): a smooth blend
  below the threshold, implemented there with ``np.vectorize`` (a Python
  per-element loop!); here it is one fused elementwise kernel.

All angles in degrees, matching the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DEG2RAD = jnp.pi / 180.


@jax.jit
def compute_orographic_updraft(wspeed: jax.Array, wdirn: jax.Array,
                               slope: jax.Array, aspect: jax.Array,
                               min_updraft_val: float = 0.) -> jax.Array:
    """Brandes-Ombalski orographic updraft (ssrs/layers.py:11-22)."""
    aspect_diff = jnp.maximum(0., jnp.cos((aspect - wdirn) * DEG2RAD))
    wval = wspeed * jnp.sin(slope * DEG2RAD) * aspect_diff
    return jnp.maximum(min_updraft_val, wval)


@jax.jit
def get_above_threshold_speed(in_array: jax.Array,
                              threshold: float) -> jax.Array:
    """Usable-updraft transform (ssrs/layers.py:171-185):

        w <= 1e-2          -> 0
        1e-2 < w <= thresh -> thresh * (exp((w/thresh)^5) - 1) / (e - 1)
        w > thresh         -> w
    """
    in_array = jnp.asarray(in_array)
    thr = jnp.asarray(threshold, dtype=in_array.dtype)
    blend = thr * (jnp.exp((in_array / thr) ** 5) - 1.) / (jnp.e - 1.)
    out = jnp.where(in_array > thr, in_array, blend)
    return jnp.where(in_array > 1e-2, out, 0.)


@jax.jit
def orographic_updraft_from_dem(z_mat: jax.Array, res: float,
                                wspeed: jax.Array, wdirn: jax.Array,
                                min_updraft_val: float = 0.) -> jax.Array:
    """Fused DEM -> (slope, aspect) -> orographic updraft in one pass.

    Avoids materializing slope/aspect in HBM; used by the uniform-mode fast
    path and the updraft benchmark.
    """
    from .terrain import compute_slope_aspect_degrees
    slope, aspect = compute_slope_aspect_degrees(z_mat, res)
    return compute_orographic_updraft(wspeed, wdirn, slope, aspect,
                                      min_updraft_val)
