"""Presence-density maps: counting and circular-kernel smoothing.

Reference semantics: ``compute_presence_counts`` (per-(track, step) Python
loop, ssrs/movmodel.py:410-419) and ``compute_smooth_presence_counts``
(flat circular kernel, normalized, 'same' 2-D convolution,
ssrs/movmodel.py:422-439). On device the counting is the scatter-add done
inside the simulation scan (``ssrs_tpu.agents.simulate``); this module adds
the smoothing and a host-compatible counting path for track lists.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def circular_kernel(krad: int) -> np.ndarray:
    """Flat circular kernel of radius ``krad``, normalized to sum 1
    (ssrs/movmodel.py:431-436)."""
    kernel = np.zeros((2 * krad + 1, 2 * krad + 1))
    y, x = np.ogrid[-krad:krad + 1, -krad:krad + 1]
    kernel[x ** 2 + y ** 2 <= krad ** 2] = 1
    return (kernel / kernel.sum()).astype(np.float32)


@partial(jax.jit, static_argnames=('krad',))
def smooth_presence(count_mat: jax.Array, krad: int) -> jax.Array:
    """'same'-mode 2-D convolution with the circular kernel. Uses direct
    convolution; FFT would only win for kernels far larger than the clip
    in ssrs/simulator.py:520 allows. HIGHEST precision: counts above
    2^11 are not exact in TF32, the GPU's default for f32 convolutions."""
    kern = jnp.asarray(circular_kernel(krad))
    x = count_mat.astype(jnp.float32)[None, None]
    k = kern[::-1, ::-1][None, None]  # convolution, not correlation
    dn = jax.lax.conv_dimension_numbers(x.shape, k.shape,
                                        ('NCHW', 'OIHW', 'NCHW'))
    pad = krad
    out = jax.lax.conv_general_dilated(x, k, (1, 1),
                                       [(pad, pad), (pad, pad)],
                                       (1, 1), (1, 1), dn,
                                       precision=jax.lax.Precision.HIGHEST)
    return out[0, 0]


def compute_presence_counts(tracks: List[np.ndarray],
                            gridshape: Tuple[int, int]) -> np.ndarray:
    """Count visits per cell over a list of (row, col) trajectories —
    vectorized equivalent of the reference loop (ssrs/movmodel.py:410-419),
    kept int16 with the same overflow behavior avoided by accumulating in
    int64 then casting."""
    if tracks:
        pts = np.concatenate([np.asarray(t).reshape(-1, 2) for t in tracks])
        flat = pts[:, 0].astype(np.int64) * gridshape[1] + pts[:, 1]
        counts = np.bincount(flat, minlength=gridshape[0] * gridshape[1])
    else:
        counts = np.zeros(gridshape[0] * gridshape[1], dtype=np.int64)
    return counts.reshape(gridshape).astype(np.int16)


def compute_smooth_presence_counts(tracks: List[np.ndarray],
                                   gridshape: Tuple[int, int],
                                   radius: float) -> np.ndarray:
    """Host-path equivalent of ssrs/movmodel.py:422-439 (device conv)."""
    counts = compute_presence_counts(tracks, gridshape)
    out = smooth_presence(jnp.asarray(counts), int(radius))
    return np.asarray(out, dtype=np.float32)


def smooth_presence_from_counts(count_mat: jax.Array,
                                radius: float) -> jax.Array:
    """Device path: smooth an on-device presence count map."""
    return smooth_presence(count_mat, int(radius))
