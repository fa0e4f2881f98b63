"""Double-single (two-float) arithmetic on device.

A value is carried as an unevaluated sum ``hi + lo`` of two float32s
(~48 significant bits), using the classic error-free transformations
(Dekker 1971, Knuth TAOCP 4.2.2). They hold only if the compiler neither
reassociates nor contracts a multiply and an add into one FMA in the
wrong place; ``chip_smoke.py`` checks ``two_sum``, ``two_prod`` and
``ds_mul_f32`` on the GPU against float64 on 10^6 random pairs
(``tests/test_ds.py`` does the same on the CPU).

Used by the directional-potential solver to evaluate residuals of the
ill-conditioned (cond ~ 1e9-1e10) reference system without f32
cancellation — see ``ssrs_tpu/potential/lap.py``. All functions are
elementwise and shape-polymorphic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Dekker split constant for float32 (2^12 + 1): splits a 24-bit mantissa
# into two 12-bit halves so products of halves are exact.
_SPLIT = jnp.float32(4097.0)


class DS(NamedTuple):
    """hi + lo with |lo| <= ulp(hi)/2 (non-overlapping)."""
    hi: jax.Array
    lo: jax.Array


def two_sum(a, b):
    """Error-free a + b -> (s, err) with s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """Error-free a * b -> (p, err) via Dekker splitting (exact for f32
    inputs whose product does not overflow)."""
    p = a * b
    a1 = a * _SPLIT
    ahi = a1 - (a1 - a)
    alo = a - ahi
    b1 = b * _SPLIT
    bhi = b1 - (b1 - b)
    blo = b - bhi
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def ds_from(x) -> DS:
    x = jnp.asarray(x, jnp.float32)
    return DS(x, jnp.zeros_like(x))


def ds_add(x: DS, y: DS) -> DS:
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    hi, lo = fast_two_sum(s, e)
    return DS(hi, lo)


def ds_neg(x: DS) -> DS:
    return DS(-x.hi, -x.lo)


def ds_sub(x: DS, y: DS) -> DS:
    return ds_add(x, ds_neg(y))


def ds_mul_f32(x: DS, w) -> DS:
    """DS * plain-f32 (the common case: stencil weight times DS value)."""
    p, e = two_prod(x.hi, w)
    e = e + x.lo * w
    hi, lo = fast_two_sum(p, e)
    return DS(hi, lo)


def ds_to_f32(x: DS) -> jax.Array:
    return x.hi + x.lo
