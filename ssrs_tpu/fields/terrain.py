"""Terrain-derivative device kernels: Horn 3x3 slope/aspect stencils.

Reference semantics: ``compute_slope_degrees`` / ``compute_aspect_degrees``
(ssrs/layers.py:63-128) — a Horn 1981 3x3 stencil with the reference's own
axis convention. Note the reference treats axis 0 of ``z`` as *x* in its
stencil naming ("upper left" = ``z[:-2, 2:]``), so dz_dx is the gradient
along axis 0 and dz_dy along axis 1; we reproduce that exactly, border cells
are zero (the reference writes NaN then ``nan_to_num``).

This is a bandwidth-bound elementwise stencil: XLA fuses the shifted
reads into a single pass, and no hand-written kernel is used here.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _horn_gradients(z_mat: jax.Array, res: float):
    """dz_dx, dz_dy on the interior via the Horn stencil
    (ssrs/layers.py:80-90). Returns arrays of shape (nrow-2, ncol-2)."""
    z_1 = z_mat[:-2, 2:]    # "upper left"
    z_2 = z_mat[1:-1, 2:]   # "upper middle"
    z_3 = z_mat[2:, 2:]     # "upper right"
    z_4 = z_mat[:-2, 1:-1]  # "center left"
    z_6 = z_mat[2:, 1:-1]   # "center right"
    z_7 = z_mat[:-2, :-2]   # "lower left"
    z_8 = z_mat[1:-1, :-2]  # "lower middle"
    z_9 = z_mat[2:, :-2]    # "lower right"
    dz_dx = ((z_3 + 2. * z_6 + z_9) - (z_1 + 2. * z_4 + z_7)) / (8. * res)
    dz_dy = ((z_1 + 2. * z_2 + z_3) - (z_7 + 2. * z_8 + z_9)) / (8. * res)
    return dz_dx, dz_dy


@partial(jax.jit, static_argnames=())
def compute_slope_degrees(z_mat: jax.Array, res: float) -> jax.Array:
    """Terrain slope (degrees) via the Horn stencil; border cells are 0
    (ssrs/layers.py:63-93)."""
    z_mat = jnp.asarray(z_mat)
    dz_dx, dz_dy = _horn_gradients(z_mat, res)
    rise_run = jnp.sqrt(dz_dx ** 2 + dz_dy ** 2)
    interior = jnp.degrees(jnp.arctan(rise_run))
    out = jnp.zeros_like(z_mat)
    out = out.at[1:-1, 1:-1].set(interior)
    return jnp.nan_to_num(out)


@partial(jax.jit, static_argnames=())
def compute_aspect_degrees(z_mat: jax.Array, res: float) -> jax.Array:
    """Terrain aspect (degrees) via the Horn stencil; border cells are 0.

    Replicates the reference's formulation exactly
    (ssrs/layers.py:96-128): zero dz_dx is replaced by 1e-10 *before* the
    arctan ratio, and aspect = 180 - atan(dy/dx) + 90*sign(dx).
    """
    z_mat = jnp.asarray(z_mat)
    dz_dx, dz_dy = _horn_gradients(z_mat, res)
    dz_dx = jnp.where(dz_dx == 0., 1e-10, dz_dx)
    angle = jnp.degrees(jnp.arctan(dz_dy / dz_dx))
    angle_mod = 90. * dz_dx / jnp.abs(dz_dx)
    interior = 180. - angle + angle_mod
    out = jnp.zeros_like(z_mat)
    out = out.at[1:-1, 1:-1].set(interior)
    return jnp.nan_to_num(out)


def _richdem_gradients(z_mat: jax.Array, res: float):
    """Horn gradients in richdem/GDAL's raster convention: x along axis 1
    (columns, "easting"), y along axis 0 with row 0 treated as the TOP of
    the raster. This differs from the reference's own stencil above, which
    treats axis 0 as x (``_horn_gradients``). Unit cell size with the
    elevations scaled by ``zscale = 1/res``, exactly as the reference
    invokes richdem (ssrs/layers.py:146-147,166-167)."""
    z = z_mat / res  # richdem's zscale multiplies the elevations
    nw, n_, ne = z[:-2, :-2], z[:-2, 1:-1], z[:-2, 2:]
    w_, e_ = z[1:-1, :-2], z[1:-1, 2:]
    sw, s_, se = z[2:, :-2], z[2:, 1:-1], z[2:, 2:]
    dz_dx = ((ne + 2. * e_ + se) - (nw + 2. * w_ + sw)) / 8.
    dz_dy = ((sw + 2. * s_ + se) - (nw + 2. * n_ + ne)) / 8.
    return dz_dx, dz_dy


@partial(jax.jit, static_argnames=())
def compute_slope_richdem_degrees(z_mat: jax.Array, res: float) -> jax.Array:
    """richdem's 'slope_degrees' attribute (ssrs/layers.py:131-148): the
    Horn 1981 stencil in richdem's raster axis convention with
    ``zscale = 1/res``. Numerically identical to ``compute_slope_degrees``
    in the interior (the gradient magnitude is axis-order invariant); the
    border carries richdem's nodata value -9999 instead of 0 (richdem is
    not installable in this offline environment, so the border convention
    is implemented per its documentation rather than cross-checked)."""
    z_mat = jnp.asarray(z_mat)
    dz_dx, dz_dy = _richdem_gradients(z_mat, res)
    interior = jnp.degrees(jnp.arctan(jnp.sqrt(dz_dx ** 2 + dz_dy ** 2)))
    out = jnp.full_like(z_mat, -9999.)
    return out.at[1:-1, 1:-1].set(jnp.nan_to_num(interior))


@partial(jax.jit, static_argnames=())
def compute_aspect_richdem_degrees(z_mat: jax.Array, res: float
                                   ) -> jax.Array:
    """richdem's 'aspect' attribute (ssrs/layers.py:151-168): the compass
    bearing of the downslope direction per Horn 1981 as implemented by
    richdem/GDAL (gdaldem) — NOT the reference's own aspect formula.

        raw = degrees(atan2(dz_dy, -dz_dx))
        aspect = 90 - raw            (raw in [0, 90])
                 360 - raw + 90      (raw > 90)
                 90 - raw            (raw < 0)

    so 0 = toward row 0's edge ("north" in richdem's top-row-north
    convention), 90 = east, proceeding clockwise. Because the Simulator
    stores rasters with a lower-left origin (row 0 = south), values are
    N/S-mirrored relative to true compass bearings — which is exactly what
    the reference's richdem call returns on the same arrays. Flat and
    border cells carry the nodata value -9999 (documented assumption;
    richdem cannot be installed offline to cross-check)."""
    z_mat = jnp.asarray(z_mat)
    dz_dx, dz_dy = _richdem_gradients(z_mat, res)
    raw = jnp.degrees(jnp.arctan2(dz_dy, -dz_dx))
    aspect = jnp.where(raw < 0., 90. - raw,
                       jnp.where(raw > 90., 360. - raw + 90., 90. - raw))
    flat = (dz_dx == 0.) & (dz_dy == 0.)
    interior = jnp.where(flat, -9999., aspect)
    out = jnp.full_like(z_mat, -9999.)
    return out.at[1:-1, 1:-1].set(interior)


@partial(jax.jit, static_argnames=())
def compute_slope_aspect_degrees(z_mat: jax.Array, res: float):
    """Fused slope+aspect in a single pass over the DEM (both consume the
    same Horn gradients; XLA fuses the whole thing into one stencil)."""
    z_mat = jnp.asarray(z_mat)
    dz_dx, dz_dy = _horn_gradients(z_mat, res)
    rise_run = jnp.sqrt(dz_dx ** 2 + dz_dy ** 2)
    slope_in = jnp.degrees(jnp.arctan(rise_run))
    dz_dx_nz = jnp.where(dz_dx == 0., 1e-10, dz_dx)
    angle = jnp.degrees(jnp.arctan(dz_dy / dz_dx_nz))
    aspect_in = 180. - angle + 90. * dz_dx_nz / jnp.abs(dz_dx_nz)
    slope = jnp.zeros_like(z_mat).at[1:-1, 1:-1].set(slope_in)
    aspect = jnp.zeros_like(z_mat).at[1:-1, 1:-1].set(aspect_in)
    return jnp.nan_to_num(slope), jnp.nan_to_num(aspect)
