"""Stochastic thermal-updraft field device kernel.

Reference semantics (``compute_thermals``, ssrs/layers.py:188-214):
for each interior cell (a 10% border is excluded),
``wtfactor = 1000 + |aspect-180|/180 * 2000`` and a thermal seed is placed
with probability ``P(randint(1, int(wtfactor)) == 5) = 1/(int(wtfactor)-1)``
with lognormal(scale+3, 0.5) magnitude; the seed field is then smoothed with
a Gaussian filter (sigma=4, zero-padded borders).

The reference does this with a per-cell Python double loop; here it is a
vectorized Bernoulli + lognormal draw and a separable Gaussian convolution,
all on device. RNG parity with NumPy's stream is impossible (different
generators), so acceptance is statistical (see tests/test_fields.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Discrete Gaussian kernel identical to scipy.ndimage's
    (radius = int(truncate*sigma + 0.5), normalized)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (float(sigma) ** 2) * x ** 2)
    return (phi / phi.sum()).astype(np.float32)


@partial(jax.jit, static_argnames=('sigma', 'truncate'))
def gaussian_filter(field: jax.Array, sigma: float = 4.0,
                    truncate: float = 4.0) -> jax.Array:
    """Separable zero-padded Gaussian blur (scipy mode='constant')."""
    kern = jnp.asarray(gaussian_kernel1d(sigma, truncate))
    ksize = kern.shape[0]
    x = field[None, None, :, :].astype(jnp.float32)
    kr = kern.reshape(1, 1, ksize, 1)
    kc = kern.reshape(1, 1, 1, ksize)
    dn = jax.lax.conv_dimension_numbers(x.shape, kr.shape,
                                        ('NCHW', 'OIHW', 'NCHW'))
    pad = (ksize - 1) // 2
    # HIGHEST: the GPU's default for f32 convolutions is TF32 (~3
    # decimal digits), not faithful to the f32 taps
    x = jax.lax.conv_general_dilated(x, kr, (1, 1),
                                     [(pad, pad), (0, 0)], (1, 1), (1, 1), dn,
                                     precision=jax.lax.Precision.HIGHEST)
    x = jax.lax.conv_general_dilated(x, kc, (1, 1),
                                     [(0, 0), (pad, pad)], (1, 1), (1, 1), dn,
                                     precision=jax.lax.Precision.HIGHEST)
    return x[0, 0]


@partial(jax.jit, static_argnames=())
def compute_thermals(key: jax.Array, aspect: jax.Array,
                     thermal_intensity_scale: float) -> jax.Array:
    """Random smoothed thermal field (ssrs/layers.py:188-214).

    ``key`` replaces the reference's global NumPy RNG state.
    """
    aspect = jnp.asarray(aspect, dtype=jnp.float32)
    ysize, xsize = aspect.shape
    border_y = int(0.1 * ysize)
    border_x = int(0.1 * xsize)

    # P(randint(1, int(wtfactor)) == 5) = 1 / (int(wtfactor) - 1)
    wtfactor = jnp.floor(1000. + (jnp.abs(aspect - 180.) / 180.) * 2000.)
    prob = 1. / (wtfactor - 1.)

    k_bern, k_mag = jax.random.split(key)
    seeds = jax.random.uniform(k_bern, aspect.shape) < prob
    # lognormal(mean=m, sigma=s) == exp(m) * lognormal(0, s)
    magnitude = jax.random.lognormal(
        k_mag, sigma=0.5, shape=aspect.shape) * jnp.exp(
            thermal_intensity_scale + 3.)

    rows = jnp.arange(ysize)[:, None]
    cols = jnp.arange(xsize)[None, :]
    interior = ((rows >= border_y) & (rows < ysize - border_y) &
                (cols >= border_x) & (cols < xsize - border_x))

    wt_init = jnp.where(seeds & interior, magnitude, 0.)
    return gaussian_filter(wt_init, sigma=4.0)
