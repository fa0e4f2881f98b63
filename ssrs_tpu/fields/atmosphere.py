"""Thermal/atmospheric scalar device kernels.

Reference semantics: ``deardoff_velocity_function`` (ssrs/layers.py:25-37),
``compute_potential_temperature`` (ssrs/layers.py:40-48),
``compute_thermal_updraft`` (ssrs/layers.py:51-60). All are pure
elementwise ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def deardoff_velocity_function(pot_temperature: jax.Array,
                               blayer_height: jax.Array,
                               surface_heat_flux: jax.Array,
                               min_updraft_val: float = 1e-5) -> jax.Array:
    """Deardoff convective velocity scale (ssrs/layers.py:25-37)."""
    fac = 9.8 / 1216.  # to produce kinematic entity
    pot_temp_kelvin = pot_temperature + 273.15
    pos_heat_flux = jnp.clip(surface_heat_flux, min=0.)
    mod_blheight = jnp.clip(blayer_height, min=100.)
    val = (fac * mod_blheight * pos_heat_flux / pot_temp_kelvin) ** (1. / 3.)
    return jnp.maximum(min_updraft_val, val)


@jax.jit
def compute_potential_temperature(pressure: jax.Array,
                                  temperature: jax.Array) -> jax.Array:
    """Potential temperature in Celsius (ssrs/layers.py:40-48)."""
    temp_k = temperature + 273.15
    ref_pressure = 1e5
    return temp_k * (ref_pressure / pressure) ** 0.2857 - 273.15


@jax.jit
def compute_thermal_updraft(zmat: jax.Array, deardoff_vel: jax.Array,
                            blayer_height: jax.Array,
                            min_updraft_val: float = 1e-5) -> jax.Array:
    """Thermal updraft at height z from the z/zi profile
    (ssrs/layers.py:51-60)."""
    zbyzi = jnp.clip(zmat / blayer_height, min=0., max=1.)
    emat = 0.85 * zbyzi ** (1. / 3.) * (1.3 - zbyzi)
    return jnp.maximum(min_updraft_val, deardoff_vel * emat)
