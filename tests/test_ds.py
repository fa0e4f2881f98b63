"""Double-single error-free transforms (potential/ds.py) against float64
on the CPU. chip_smoke.py makes the same check on the GPU, where the
compiler could contract a multiply and an add into one FMA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssrs_tpu.potential.ds import DS, ds_mul_f32, two_prod, two_sum


def _f32(rng, n, emin, emax):
    return (rng.choice([-1., 1.], n) * np.ldexp(
        rng.uniform(1., 2., n), rng.integers(emin, emax + 1, n))
    ).astype(np.float32)


@pytest.mark.parametrize('fn', ['two_sum', 'two_prod', 'ds_mul_f32'])
def test_error_free_transform_vs_float64(fn):
    rng = np.random.default_rng(0)
    n = 100_000
    if fn == 'ds_mul_f32':
        x = rng.uniform(-1., 1., n) * np.ldexp(1., rng.integers(-30, 31, n))
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
        w = _f32(rng, n, -30, 30)
        r = jax.jit(lambda h, l, w: ds_mul_f32(DS(h, l), w))(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(w))
        got = np.asarray(r.hi, np.float64) + np.asarray(r.lo, np.float64)
        want = (hi.astype(np.float64) + lo) * w.astype(np.float64)
        # a few units of the DS roundoff 2^-48
        assert (np.abs(got - want) / np.abs(want)).max() < 2.0 ** -44
        return
    emax = 100 if fn == 'two_sum' else 30
    a, b = _f32(rng, n, -emax, emax), _f32(rng, n, -emax, emax)
    f = {'two_sum': two_sum, 'two_prod': two_prod}[fn]
    hi, lo = jax.jit(f)(jnp.asarray(a), jnp.asarray(b))
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    want = a64 + b64 if fn == 'two_sum' else a64 * b64
    # exact: both sides are the float64 rounding of the same real number
    np.testing.assert_array_equal(got, want)
