"""Matrix-free directional-potential solver.

Reference semantics (``MovModel.solve_sparse_linear_system``,
ssrs/movmodel.py:86-128): build the 8-neighbor transition graph with edge
weights ``harmonic_mean(cond_i, cond_j, 1e-8) / fac``, row-normalize, and
solve ``(I - P_ii) x = P_ib b`` with SuperLU. The assembly there is a
Python loop over all nodes and edges; the solve is a host sparse direct
factorization.

Device formulation: the operator ``P`` is nine shifted elementwise
multiplies (a 9-point stencil) — no sparse matrix is ever materialized.
With Dirichlet cells clamped, the full-grid linear operator

    L(u) = u - (1 - bmask) * sum_d P_d * shift_d(u),   rhs = bmask * bvals

has unit diagonal and is solved with BiCGStab (nonsymmetric: the
row-normalization, and one reference quirk below, break symmetry).

Reference quirks reproduced exactly (verified against a dense oracle in
tests/test_potential.py):
- ``harmonic_mean`` returns the floor 1e-8 only when either conductivity is
  exactly zero (ssrs/movmodel.py:442-447) — it does NOT floor small values.
- Edge ``fac`` is sqrt(2) for diagonals and 1 for axials *except* on
  east-column non-corner nodes, where the alternating-fac assembly after
  neighbor filtering (ssrs/movmodel.py:66-79) swaps the facs of the
  ``(-1, 0)`` and ``(-1, -1)`` edges.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..agents.moves import NEIGHBOR_DELTAS

SQRT2 = float(np.sqrt(2.0))

# the eight off-center move indices and their default fac
_DIRS = [m for m in range(9) if m != 4]


def _fac_plane(dr: int, dc: int, rows: jax.Array, cols: jax.Array,
               nrow: int, ncol: int):
    """Per-direction fac divisor, built from index iotas on device (an
    embedded (8, nrow, ncol) constant made large-grid graphs uncompilable),
    including the east-column quirk (see module docstring)."""
    base = SQRT2 if (dr != 0 and dc != 0) else 1.0
    if (dr, dc) not in ((-1, 0), (-1, -1)):
        return base
    east_inner = ((cols == ncol - 1) & (rows >= 1) & (rows <= nrow - 2))
    swapped = SQRT2 if (dr, dc) == (-1, 0) else 1.0
    return jnp.where(east_inner, swapped, base)


def _shift(x: jax.Array, dr: int, dc: int) -> jax.Array:
    """x(r+dr, c+dc), zero outside the grid."""
    nrow, ncol = x.shape
    xpad = jnp.pad(x, 1)
    return jax.lax.dynamic_slice(xpad, (dr + 1, dc + 1), (nrow, ncol))


def transition_planes(conductivity: jax.Array) -> jax.Array:
    """Row-normalized transition probabilities P_d, shape (8, nrow, ncol).

    P_d(r, c) = w_d / sum_d' w_d' with
    w_d = hm(cond(r, c), cond(r+dr, c+dc)) / fac_d for in-grid neighbors,
    hm(a, b) = 2/(1/a + 1/b) if a != 0 and b != 0 else 1e-8.
    """
    cond = jnp.asarray(conductivity, jnp.float32)
    nrow, ncol = cond.shape

    rows = jax.lax.broadcasted_iota(jnp.int32, (nrow, ncol), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (nrow, ncol), 1)

    planes = []
    for k, m in enumerate(_DIRS):
        dr, dc = int(NEIGHBOR_DELTAS[m, 0]), int(NEIGHBOR_DELTAS[m, 1])
        nbr = _shift(cond, dr, dc)
        both_nz = (cond != 0.) & (nbr != 0.)
        # guard the reciprocals; selected away when either side is zero
        safe_c = jnp.where(cond == 0., 1., cond)
        safe_n = jnp.where(nbr == 0., 1., nbr)
        hm = jnp.where(both_nz, 2.0 / (1.0 / safe_c + 1.0 / safe_n), 1e-8)
        in_grid = ((rows + dr >= 0) & (rows + dr < nrow) &
                   (cols + dc >= 0) & (cols + dc < ncol))
        fac = _fac_plane(dr, dc, rows, cols, nrow, ncol)
        planes.append(jnp.where(in_grid, hm / fac, 0.))
    w = jnp.stack(planes)
    return w / jnp.sum(w, axis=0, keepdims=True)


def _apply_p(p_planes: jax.Array, u: jax.Array) -> jax.Array:
    """(P u)(r, c) = sum_d P_d(r, c) * u(r+dr, c+dc). Pads once and takes
    eight static slices (padding per shift cost 8x the memory traffic on
    multi-megacell grids)."""
    nrow, ncol = u.shape
    upad = jnp.pad(u, 1)
    out = jnp.zeros_like(u)
    for k, m in enumerate(_DIRS):
        dr, dc = int(NEIGHBOR_DELTAS[m, 0]), int(NEIGHBOR_DELTAS[m, 1])
        out = out + p_planes[k] * jax.lax.slice(
            upad, (dr + 1, dc + 1), (dr + 1 + nrow, dc + 1 + ncol))
    return out


def solve_potential(conductivity: jax.Array, bmask: jax.Array,
                    bvals: jax.Array, tol: float = 1e-6,
                    maxiter: int = 0) -> Tuple[jax.Array, jax.Array]:
    """Solve for the directional potential on the full grid (device path).

    Kept as the legacy row-normalized multigrid entry point (reaches the
    f32-representable fixed point of ``I - P``). For f64-oracle-accurate
    answers on hard conductivity fields use ``solve_potential_refined``
    (potential/lap.py), which the Simulator's 'auto' policy selects.
    Returns (potential float32 (nrow, ncol), residual-norm scalar).
    """
    from .multigrid import solve_potential_mg
    maxcycles = maxiter if maxiter > 0 else 200
    return solve_potential_mg(conductivity, bmask, bvals, tol=tol,
                              maxcycles=maxcycles)


def solve_potential_for_direction(conductivity: jax.Array, move_dirn: float,
                                  tol: float = 1e-6,
                                  maxiter: int = 0):
    """Convenience wrapper: directed boundary conditions + solve
    (mirrors ``Simulator.get_directional_potential``,
    ssrs/simulator.py:259-288, minus the file cache)."""
    from .boundary import boundary_masks
    nrow, ncol = np.asarray(conductivity).shape
    bmask, bvals = boundary_masks(move_dirn, (nrow, ncol))
    return solve_potential(conductivity, jnp.asarray(bmask),
                           jnp.asarray(bvals), tol=tol, maxiter=maxiter)
