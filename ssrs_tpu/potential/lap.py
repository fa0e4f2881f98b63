"""Reference-exact directional potential on device: difference-form
operator + Galerkin multigrid + double-single iterative refinement +
island deflation.

Why the earlier row-normalized formulation could not match the f64 oracle
in f32 (measured in round 1, analysis in ``direct.py``): the system's hard
modes are the *levels* of high-conductivity islands surrounded by
zero-conductivity plateaus, coupled only through the reference's 1e-8
harmonic-mean floor (ssrs/movmodel.py:442-447). In the ``u - P u`` form,
float32 rounding of the row-normalized planes leaves row-sum defects of
~1e-7 — an order larger than the true 1e-8 leak couplings — so the f32
operator itself mis-levels every island by O(100) out of 1000.

This module removes the disease structurally instead of chasing digits:

1. **Difference form.** The same linear system (row normalization does not
   change the solution: ``(I - D^-1 W) x = D^-1 W b  <=>  (D - W) x = W b``)
   is applied as ``A u (i) = sum_d W_d(i) * (u_i - u_{i+d})`` — constants
   are *exactly* annihilated in any precision, so no row-sum defects exist
   by construction, and each edge term carries only ~1 ulp relative error.
2. **Double-single refinement.** The solution is carried as a two-float
   (hi, lo) pair and residuals are evaluated with error-free
   transformations (``ds.py``), so the ~1e-8-of-u island imbalance is
   visible instead of drowning in f32 cancellation noise (~3e-5 of u).
3. **Island deflation.** Connected components of ``cond > 0`` not anchored
   to the Dirichlet perimeter are a near-null subspace (eigenvalue ~
   leak/O(1)); a per-island subspace correction
   ``u += z_I (z_I^T r)/(z_I^T A z_I)`` fixes their levels in one shot per
   refinement pass.
4. **Galerkin coarse grids.** With piecewise-constant prolongation and
   block-sum restriction, the Galerkin coarse operator of a difference-form
   stencil is again a difference-form stencil whose coarse edge weights are
   the sums of fine edges crossing the block boundary — so the 1e-8/O(1)
   contrast survives coarsening exactly (the round-1 rediscretization
   blurred zero plateaus into nonzero coarse conductivity, which is where
   the 0.86/cycle rate came from).

Per-island reductions go through a *tiled label dictionary*: islands are
spatially local, so a 32x32 tile touches only a few distinct labels;
per-island sums become a fused masked reduction over dense per-tile slots
(8 frequency-ordered slots + an exact COO list for the rare overflow
cells) plus a small second stage over active slots only, and transfer
operators are ``reduce_window`` / selector-matrix matmuls. The dictionary
stands in for ``jax.ops.segment_sum`` / ``c[labels]`` over every cell;
which of the two is faster on the GPU has not been measured.

Reference semantics: ``MovModel.solve_sparse_linear_system``
(ssrs/movmodel.py:86-128), edge weights ``harmonic_mean/fac`` with the
east-column fac quirk (see ``solver.py``).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..agents.moves import NEIGHBOR_DELTAS
from .ds import DS, ds_add, ds_from, ds_mul_f32, ds_sub
from .solver import _DIRS, _fac_plane, _shift

_DELTAS = [(int(NEIGHBOR_DELTAS[m, 0]), int(NEIGHBOR_DELTAS[m, 1]))
           for m in _DIRS]
_DELTA_TO_K = {d: k for k, d in enumerate(_DELTAS)}

# f32 dots on the GPU default to TF32 (~3 decimal digits), far too
# coarse for this solver: every f32 dot here passes precision=_HI
_HI = jax.lax.Precision.HIGHEST


def weight_planes(conductivity: jax.Array) -> jax.Array:
    """Unnormalized edge weights ``W_d = hm(cond_i, cond_j) / fac_d``,
    shape (8, nrow, ncol); zero for out-of-grid neighbors. The
    row-normalized planes of ``solver.transition_planes`` are
    ``W / sum_d W``."""
    cond = jnp.asarray(conductivity, jnp.float32)
    nrow, ncol = cond.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (nrow, ncol), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (nrow, ncol), 1)
    planes = []
    for k, (dr, dc) in enumerate(_DELTAS):
        nbr = _shift(cond, dr, dc)
        both_nz = (cond != 0.) & (nbr != 0.)
        safe_c = jnp.where(cond == 0., 1., cond)
        safe_n = jnp.where(nbr == 0., 1., nbr)
        hm = jnp.where(both_nz, 2.0 / (1.0 / safe_c + 1.0 / safe_n), 1e-8)
        in_grid = ((rows + dr >= 0) & (rows + dr < nrow) &
                   (cols + dc >= 0) & (cols + dc < ncol))
        fac = _fac_plane(dr, dc, rows, cols, nrow, ncol)
        planes.append(jnp.where(in_grid, hm / fac, 0.))
    return jnp.stack(planes)


def symmetrize_planes(planes: jax.Array) -> jax.Array:
    """Pairwise-symmetrized edge weights ``W_sym = 0.5 (W_ij + W_ji)``.

    The reference's east-column fac quirk (``solver.py`` docstring,
    ssrs/movmodel.py:66-79) makes W genuinely NONSYMMETRIC on the edges
    between the two easternmost columns (|W_ij − W_ji| up to ~0.29 W on
    strong edges); everywhere else W is symmetric and ``W_sym == W``.
    For a FLOATING island touching that strip, the indicator z is a
    right near-null vector of A but not a left one, so the deflation
    coefficient ``z^T r / z^T A z`` is an *oblique* projection whose
    genuine value explodes (measured on the round-3 fuzz stall field:
    c ~ 2e6 out of a 0..1000 potential) and poisons every Krylov
    direction the V-cycle produces — GCR then correctly rejects them
    (alpha ~ 3e-5) and the solve stalls. The production solver
    therefore builds the whole preconditioner hierarchy (smoother,
    Galerkin coarsening, per-level deflation) on the symmetrized
    operator — where deflation is a sound orthogonal projection at
    every level — and lets the double-single refinement loop, whose
    residuals use the TRUE operator, iterate the localized skew part
    away (``rho(S^-1 (S-A))`` ~ 0.3 on the strip, 0 elsewhere; see
    docs/DESIGN.md round-3 "The east-strip deflation stall")."""
    out = []
    for k, (dr, dc) in enumerate(_DELTAS):
        kopp = _DELTA_TO_K[(-dr, -dc)]
        w_opp_n = _shift(planes[kopp], dr, dc)
        out.append(jnp.where(planes[k] > 0.,
                             0.5 * (planes[k] + w_opp_n), 0.))
    return jnp.stack(out)


def _apply_lap(planes: jax.Array, u: jax.Array) -> jax.Array:
    """A u = sum_d W_d * (u - shift_d(u)). One pad, eight static slices;
    bandwidth-bound."""
    nrow, ncol = u.shape
    upad = jnp.pad(u, 1)
    acc = jnp.zeros_like(u)
    for k, (dr, dc) in enumerate(_DELTAS):
        nb = jax.lax.slice(upad, (dr + 1, dc + 1),
                           (dr + 1 + nrow, dc + 1 + ncol))
        acc = acc + planes[k] * (u - nb)
    return acc


def apply_lap_ds(planes: jax.Array, u: DS) -> DS:
    """A u in double-single: differences and accumulation are error-free,
    edge weights are plain f32 (their ~1 ulp relative error perturbs the
    solution by only ~1e-7 * 1000)."""
    nrow, ncol = u.hi.shape
    ph = jnp.pad(u.hi, 1)
    pl = jnp.pad(u.lo, 1)
    acc = DS(jnp.zeros_like(u.hi), jnp.zeros_like(u.hi))
    for k, (dr, dc) in enumerate(_DELTAS):
        nh = jax.lax.slice(ph, (dr + 1, dc + 1),
                           (dr + 1 + nrow, dc + 1 + ncol))
        nl = jax.lax.slice(pl, (dr + 1, dc + 1),
                           (dr + 1 + nrow, dc + 1 + ncol))
        diff = ds_sub(u, DS(nh, nl))
        acc = ds_add(acc, ds_mul_f32(diff, planes[k]))
    return acc


# A "strip-skew" factored true operator (A_true = A_sym + a tiny
# (8, nrow, 2) east-strip delta, freeing the full true planes after the
# prologue, −2 GB at 8192²) was implemented and measured as a NEGATIVE
# result: composed under the solver jit, XLA's fusion choices broke the
# double-single error-free transforms (residual error 7e-5 vs the 4e-11
# of the plain path — fusion-context-dependent: a minimal jit of the
# same composition was accurate, and optimization_barrier did not fix
# the full graph), which poisoned the island sums and mis-leveled
# sound islands by O(10). Residuals therefore keep the materialized
# full true planes; see docs/DESIGN.md round-3 "east-strip" section.


def _pad_even(x: jax.Array, fill=0.) -> jax.Array:
    nrow, ncol = x.shape[-2:]
    pr, pc = nrow % 2, ncol % 2
    if pr or pc:
        cfg = [(0, 0)] * (x.ndim - 2) + [(0, pr), (0, pc)]
        x = jnp.pad(x, cfg, constant_values=fill)
    return x


def _galerkin_map():
    """For each coarse direction kc, the list of (fine plane k, block
    offset (i, j)) whose fine edges cross into coarse neighbor kc."""
    out = {kc: [] for kc in range(8)}
    for k, (dr, dc) in enumerate(_DELTAS):
        for i in (0, 1):
            for j in (0, 1):
                di, dj = (i + dr) // 2, (j + dc) // 2
                if (di, dj) == (0, 0):
                    continue  # internal fine edge
                out[_DELTA_TO_K[(di, dj)]].append((k, i, j))
    return out


_GALERKIN_MAP = _galerkin_map()


def _galerkin_coarsen(planes: jax.Array) -> jax.Array:
    """Coarse difference-form planes: coarse edge (I -> J) weight is the
    sum of fine edges from block I into block J (RAP with piecewise-
    constant prolongation / block-sum restriction). Fine edges internal to
    a block vanish — they are invisible to block-constant functions.

    Implementation: parity masks + 2x2/2 reduce_window per coarse
    direction. Build-time only."""
    wp = _pad_even(planes)
    m2, n2 = wp.shape[-2:]
    ri = jax.lax.broadcasted_iota(jnp.int32, (m2, n2), 0) % 2
    ci = jax.lax.broadcasted_iota(jnp.int32, (m2, n2), 1) % 2
    par = {(i, j): ((ri == i) & (ci == j)).astype(wp.dtype)
           for i in (0, 1) for j in (0, 1)}

    def block_sum(x):
        return jax.lax.reduce_window(x, 0., jax.lax.add, (2, 2), (2, 2),
                                     'VALID')

    coarse = []
    for kc in range(8):
        acc = jnp.zeros((m2, n2), wp.dtype)
        for k, i, j in _GALERKIN_MAP[kc]:
            acc = acc + wp[k] * par[(i, j)]
        coarse.append(block_sum(acc))
    return jnp.stack(coarse)


def _coarsen_bmask(bmask: jax.Array) -> jax.Array:
    """Coarse cell is Dirichlet if any fine cell in its block is (the
    coarse correction must vanish there)."""
    return _restrict(bmask.astype(jnp.float32)) > 0.


def _restrict(r: jax.Array) -> jax.Array:
    """Block-sum restriction (adjoint of piecewise-constant
    prolongation): 2x2/2 reduce_window — measured at memcpy speed, vs
    ~200 ms for strided slices at 16.8M cells."""
    rp = _pad_even(r)
    return jax.lax.reduce_window(rp, 0., jax.lax.add, (2, 2), (2, 2),
                                 'VALID')


def _sel2(mc: int, m: int, dtype) -> jax.Array:
    """(mc, m) 0/1 selector: row i covers fine columns 2i, 2i+1."""
    i = jax.lax.broadcasted_iota(jnp.int32, (mc, m), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (mc, m), 1)
    return (j // 2 == i).astype(dtype)


def _prolong_pc(e: jax.Array, fine_shape: Tuple[int, int]) -> jax.Array:
    """Piecewise-constant prolongation, cropped to the fine shape.

    Rows: 2x repeat via broadcast+reshape along the major axis, which
    is row-LOCAL under row sharding — a selector matmul here would
    contract the sharded axis, which GSPMD can only implement by
    all-gathering the operand (an ncells/2 gather per V-cycle level).
    Columns: selector matmul."""
    m, n = e.shape
    er = jnp.broadcast_to(e[:, None, :], (m, 2, n)).reshape(2 * m, n)
    er = er[:fine_shape[0]]
    up_c = _sel2(n, 2 * n, e.dtype)
    # the 0/1 selector is exact in TF32 but ``er`` is not: HIGHEST
    out = jnp.matmul(er, up_c, precision=_HI)
    return out[:, :fine_shape[1]]


# ---- tiled island-label dictionaries ---------------------------------------
#
# Per-island reductions (deflation, zaz, refinement island updates) use a
# per-level tile structure built ONCE per solve on the host:
#   - the grid is cut into 32x32 tiles (padded); each tile has a local
#     dictionary of the distinct labels it touches (slot 0 is always
#     background 0);
#   - ``lidx`` maps each cell to its tile-local slot; a one-hot over slots
#     (materialized per solve on device, f32) turns per-slot sums and
#     broadcasts into batched matmuls that stream at HBM bandwidth;
#   - a compacted list of *active* slots (``sidx``/``sisland``) routes the
#     tiny per-slot partials to/from global island ids with S-sized
#     gathers/scatters (S ~ sum of per-tile label counts << cells).

_TILE = 32


_DENSE_L = 8  # dense one-hot slots per tile; the rest go to the COO


class TileSeg(NamedTuple):
    """Host-built per-level tile structure (device arrays).

    Slots are frequency-ordered per tile (slot 0 pinned to background,
    slots 1..7 the most populous islands): the dense one-hot then covers
    >97% of cells on the traffic-dominant fine levels with L=8 instead
    of the per-level max label count (64-512 on hard 4096² fields) — an
    8-64x cut in the bytes every deflation reduction re-reads. The few
    cells
    whose island didn't make a tile's top 7 are carried exactly in a
    per-level COO list (ocell/oisland) and summed/scattered directly.
    """
    lidx: jax.Array     # (T, C) int16: tile-local slot of each cell
    #                     (values >= Ld mean "in the COO list")
    slots: jax.Array    # (T, Ld) int32: global label per dense slot
    slot_iota: jax.Array  # (Ld,) int16 arange — carries the adaptive
    #                     dense width statically into the jit
    sidx: jax.Array     # (S,) int32: flat t*Ld+l of active slots (0-pad)
    sisland: jax.Array  # (S,) int32: island id per active slot (0-pad)
    ocell: jax.Array    # (O,) int32: flat tile-major cell index of
    #                     overflow cells (0-pad; routes to island 0)
    oisland: jax.Array  # (O,) int32: island id per overflow cell (0-pad)
    labels: jax.Array   # (nrow, ncol) int32 dense labels (zaz build only)


def _tiled_dims(shape: Tuple[int, int]) -> Tuple[int, int]:
    return (-(-shape[0] // _TILE) * _TILE, -(-shape[1] // _TILE) * _TILE)


def _to_tiles(x: jax.Array) -> jax.Array:
    """(m, n) -> (T, C) tile-major layout (zero-padded)."""
    m, n = x.shape
    mp, npad = _tiled_dims((m, n))
    if (mp, npad) != (m, n):
        x = jnp.pad(x, ((0, mp - m), (0, npad - n)))
    tr, tc = mp // _TILE, npad // _TILE
    x = x.reshape(tr, _TILE, tc, _TILE).transpose(0, 2, 1, 3)
    return x.reshape(tr * tc, _TILE * _TILE)


def _from_tiles(xt: jax.Array, shape: Tuple[int, int]) -> jax.Array:
    mp, npad = _tiled_dims(shape)
    tr, tc = mp // _TILE, npad // _TILE
    x = xt.reshape(tr, tc, _TILE, _TILE).transpose(0, 2, 1, 3)
    return x.reshape(mp, npad)[:shape[0], :shape[1]]


def _tile_segsum(x: jax.Array, lidx: jax.Array, slot_iota: jax.Array,
                 sidx: jax.Array,
                 sisland: jax.Array, num: int,
                 ocell: jax.Array, oisland: jax.Array) -> jax.Array:
    """Per-island sums of x: dense-8 masked reduction + S-sized routing,
    plus the exact COO contribution of overflow cells. Padded ocell
    entries point at cell 0 / island 0, whose sum is never used.

    The slot selector ``lidx == l`` is fused into the reduction — no
    one-hot array is materialized (a (T, C, L_max) f32 one-hot per level
    is 4.3 GB at the 4096² fine level); the compare-select-reduce reads
    only lidx (int16) + x.

    Accumulation is f32 (the reduce); deflation's 1e-8 zaz division
    forbids bf16 anywhere in this path (measured, see git history)."""
    xt = _to_tiles(x)
    sel = lidx[:, None, :] == slot_iota[None, :, None]
    part = jnp.sum(jnp.where(sel, xt[:, None, :], 0.), axis=2)  # (T, Ld)
    vals = part.reshape(-1)[sidx]
    ovals = xt.reshape(-1)[ocell]
    return jax.ops.segment_sum(jnp.concatenate([vals, ovals]),
                               jnp.concatenate([sisland, oisland]),
                               num_segments=num)


def _tile_broadcast(c: jax.Array, lidx: jax.Array, slot_iota: jax.Array,
                    sidx: jax.Array,
                    sisland: jax.Array, shape: Tuple[int, int],
                    ocell: jax.Array, oisland: jax.Array) -> jax.Array:
    """Per-cell image of per-island values c (c[0] must be 0): S-sized
    routing into per-tile slots + fused slot-select back-broadcast (each
    cell matches at most one slot, so the sum over l picks exactly its
    value — order-independent), plus a scatter for the overflow cells
    (padded entries add c[0] == 0 to cell 0 — harmless by the caller
    contract)."""
    T, C = lidx.shape
    L = slot_iota.shape[0]
    cvals = c[sisland]
    cl = jnp.zeros((T * L,), c.dtype).at[sidx].set(cvals).reshape(T, L)
    sel = lidx[:, None, :] == slot_iota[None, :, None]
    back = jnp.sum(jnp.where(sel, cl[:, :, None], 0.), axis=1)  # (T, C)
    back = back.reshape(-1).at[ocell].add(c[oisland]).reshape(T, C)
    return _from_tiles(back, shape)


def _host_coarsen_labels(labels: np.ndarray, bmask: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Host replica of the device level coarsening: coarse Dirichlet =
    any fine Dirichlet in the 2x2 block; coarse label = max fine label,
    zeroed on coarse Dirichlet cells. When distinct islands merge into one
    cell at deep levels, the union is still a valid 1-D deflation subspace
    for that level."""
    m, n = labels.shape
    mp, npad = m + (m % 2), n + (n % 2)
    lab = np.zeros((mp, npad), labels.dtype)
    lab[:m, :n] = labels
    bm = np.zeros((mp, npad), bool)
    bm[:m, :n] = bmask
    bm_c = (bm[::2, ::2] | bm[1::2, ::2] | bm[::2, 1::2] | bm[1::2, 1::2])
    lab_c = np.maximum(np.maximum(lab[::2, ::2], lab[1::2, ::2]),
                       np.maximum(lab[::2, 1::2], lab[1::2, 1::2]))
    lab_c[bm_c] = 0
    return lab_c, bm_c


def _build_tile_level(labels: np.ndarray):
    """Vectorized host construction of one level's tile dictionary.
    Returns (lidx (T, C) int16, slots (T, L) int32, sidx (S,), sisland
    (S,)) as numpy; a virtual background entry guarantees slot 0 == label
    0 in every tile, so zero-padded ``sidx`` entries route harmlessly to
    island 0."""
    m, n = labels.shape
    mp, npad = _tiled_dims((m, n))
    lt = np.zeros((mp, npad), np.int32)
    lt[:m, :n] = labels
    tr, tc = mp // _TILE, npad // _TILE
    lt = lt.reshape(tr, _TILE, tc, _TILE).transpose(0, 2, 1, 3)
    lt = lt.reshape(tr * tc, _TILE * _TILE)
    T, C = lt.shape
    aug = np.concatenate([np.zeros((T, 1), np.int32), lt], axis=1)
    # np.sort (radix, ~100x argsort) + one global searchsorted for the
    # cell->slot inverse: the argsort/put_along_axis formulation cost
    # ~4.4 s at 16.8M cells, this one ~1 s.
    st = np.sort(aug, axis=1)
    new = np.ones((T, C + 1), bool)
    new[:, 1:] = st[:, 1:] != st[:, :-1]
    slot_sorted = np.cumsum(new, axis=1, dtype=np.int32) - 1
    L = 8
    while L < int(slot_sorted[:, -1].max()) + 1:
        L *= 2
    # per-tile sorted dictionaries, padded with a sentinel above any label
    tidx = np.broadcast_to(np.arange(T)[:, None], st.shape)
    sent = np.int64(1) << 31
    dpad = np.full((T, L), sent, np.int64)
    dpad[tidx[new], slot_sorted[new]] = st[new]
    slots = np.where(dpad >= sent, 0, dpad).astype(np.int32)
    # cell -> slot: row-offset keys make one flat sorted array of all
    # tile dictionaries; searchsorted(left) returns t*L + slot exactly
    stride = np.int64(1) << 32
    offs = np.arange(T, dtype=np.int64)[:, None] * stride
    big = (dpad + offs).ravel()
    pos = np.searchsorted(big, (lt.astype(np.int64) + offs).ravel())
    lidx = (pos.reshape(T, C) -
            np.arange(T, dtype=np.int64)[:, None] * L).astype(np.int32)

    # frequency-reorder slots per tile (slot 0 pinned to background) so
    # the first Ld slots cover the most populous islands; cells of the
    # remaining rare islands are carried exactly by the COO list
    counts = np.bincount(
        (np.arange(T, dtype=np.int64)[:, None] * L + lidx).ravel(),
        minlength=T * L).reshape(T, L)  # np.add.at is 10-50x slower
    key = counts.astype(np.int64)
    key[:, 0] = np.iinfo(np.int64).max  # pin background at slot 0
    order = np.argsort(-key, axis=1, kind='stable')   # new pos -> old slot
    inv = np.empty_like(order)
    np.put_along_axis(inv, order,
                      np.broadcast_to(np.arange(L)[None, :], (T, L)),
                      axis=1)                          # old slot -> new pos
    lidx = inv[np.arange(T)[:, None], lidx].astype(np.int16)
    # adaptive dense width: grow Ld (pow2, >= _DENSE_L) until the COO
    # list holds <= 1/64 of the cells. Without this, an adversarial
    # many-labels-per-tile field (e.g. uniform random labels) would push
    # most cells into the COO and its segment_sum degrades to the
    # ~7 ns/element serial scatter this whole design exists to avoid;
    # with it, Ld simply approaches the old dense L_max there.
    Ld = _DENSE_L
    while Ld < L and int((lidx >= Ld).sum()) > (T * C) // 64:
        Ld *= 2
    slots = np.take_along_axis(slots, order, axis=1)[:, :Ld]

    flat = slots.ravel()
    sidx = np.nonzero(flat)[0].astype(np.int32)
    sisland = flat[sidx].astype(np.int32)
    over = (lidx >= Ld).ravel()
    ocell = np.nonzero(over)[0].astype(np.int32)
    oisland = lt.reshape(-1)[ocell].astype(np.int32)
    # quantize S/O in powers of 4: they only size small routing vectors,
    # and every distinct (num, S, O) combination is a separate XLA
    # compile — a seasonal sweep with per-case fields was paying
    # ~2-4 min per combination (measured: 24 cases cost 800 s of mostly
    # compiles)
    S = 256
    while S < len(sidx):
        S *= 4
    sidx = np.pad(sidx, (0, S - len(sidx)))
    sisland = np.pad(sisland, (0, S - len(sisland)))
    O = 256
    while O < len(ocell):
        O *= 4
    ocell = np.pad(ocell, (0, O - len(ocell)))
    oisland = np.pad(oisland, (0, O - len(oisland)))
    return lidx, slots, sidx, sisland, ocell, oisland


def _build_tile_hierarchy_host(labels: np.ndarray, bmask: np.ndarray,
                               min_size: int = 4) -> List[TileSeg]:
    """Host: per-level tile dictionaries for the whole V-cycle hierarchy
    (one ``island_labels`` + one pass of numpy per solve); numpy leaves."""
    out = []
    lab = np.asarray(labels, np.int32)
    bm = np.asarray(bmask, bool)
    while True:
        lidx, slots, sidx, sisland, ocell, oisland = _build_tile_level(lab)
        out.append(TileSeg(lidx=lidx, slots=slots,
                           slot_iota=np.arange(slots.shape[1],
                                               dtype=np.int16),
                           sidx=sidx,
                           sisland=sisland, ocell=ocell,
                           oisland=oisland, labels=lab))
        if min(lab.shape) <= min_size:
            break
        lab, bm = _host_coarsen_labels(lab, bm)
    return out


def build_tile_hierarchy(labels: np.ndarray, bmask: np.ndarray,
                         min_size: int = 4) -> List[TileSeg]:
    """Host: per-level tile dictionaries for the whole V-cycle hierarchy
    (one ``island_labels`` + one pass of numpy per solve)."""
    # ONE batched device_put for the whole hierarchy (~40 arrays per
    # solve) instead of one transfer per array
    return jax.device_put(_build_tile_hierarchy_host(labels, bmask,
                                                     min_size))


def _stack_tile_hierarchies(hiers: Sequence[List[TileSeg]]
                            ) -> List[TileSeg]:
    """Stack per-case hierarchies (same grid => same level count and
    (T, C) shapes) into one batched hierarchy with a leading case axis,
    padding the per-case quantized widths (dense Ld, routing S, COO O)
    up to the per-level maxima. Zero padding is the SAME mechanism
    ``_build_tile_level`` already uses inside one case: padded ``sidx``
    entries route tile-0/slot-0 sums to island 0 (never used, callers
    pin c[0] = 0), padded ``slots`` columns are matched by no cell and
    are not in ``sidx``, padded ``ocell`` entries add c[0] == 0 to
    cell 0."""
    out = []
    for segs in zip(*hiers):
        Ld = max(s.slot_iota.shape[0] for s in segs)
        S = max(s.sidx.shape[0] for s in segs)
        O = max(s.ocell.shape[0] for s in segs)

        def padw(a, w):
            return np.pad(a, [(0, w - a.shape[0])] + [(0, 0)] *
                          (a.ndim - 1))

        def restride_sidx(s, Ld=Ld):
            # sidx entries are FLAT indices into the case's own (T, Ld)
            # dense layout; widening Ld changes the stride, so they must
            # be re-laid out for the padded width. Without this, any
            # case whose adaptive dense width is below the batch max
            # reads scrambled per-tile sums — measured on the 500x600
            # probe fields as 3e-3 batched residuals for cases that
            # solve to 3e-7 alone (round-5 fix; small grids all sit at
            # the minimum width, which is why per-case == batched tests
            # passed). Padded zero entries map to zero (t=0, slot=0).
            ld_case = s.slot_iota.shape[0]
            t, sl = np.divmod(s.sidx.astype(np.int64), ld_case)
            return (t * Ld + sl).astype(np.int32)

        out.append(TileSeg(
            lidx=np.stack([s.lidx for s in segs]),
            slots=np.stack([np.pad(s.slots,
                                   ((0, 0), (0, Ld - s.slots.shape[1])))
                            for s in segs]),
            slot_iota=np.broadcast_to(np.arange(Ld, dtype=np.int16),
                                      (len(segs), Ld)).copy(),
            sidx=np.stack([padw(restride_sidx(s), S) for s in segs]),
            sisland=np.stack([padw(s.sisland, S) for s in segs]),
            ocell=np.stack([padw(s.ocell, O) for s in segs]),
            oisland=np.stack([padw(s.oisland, O) for s in segs]),
            labels=np.stack([s.labels for s in segs])))
    return out


# ---- level hierarchy --------------------------------------------------------


class LapLevel(NamedTuple):
    planes: jax.Array   # (8, nrow, ncol) difference-form edge weights
    # labels: the deflation numerator sums the residual through
    # CROSSING edges only (island-internal edges zeroed on the fly; see
    # _apply_lap_crossing). For a symmetric operator the island sum of
    # A u gets ZERO from island-internal edges (the pair W(u_i-u_j) +
    # W(u_j-u_i) cancels exactly), so crossing-only sums equal full
    # sums in exact arithmetic — but in f32 the internal strong-edge
    # products (O(1) each) leave cancellation noise ~1e-7 absolute in
    # the sum, which the 1/zaz ~ 1e8 division turns into
    # O(10)-potential-unit garbage corrections every cycle (measured:
    # island sums of A u through the full planes come back as pure
    # noise — 0.0 or off by 15% — while crossing-only sums match the
    # f64 truth to 7 digits). The mask is computed per _deflate from
    # these labels rather than stored as a second plane stack: a
    # materialized (8, nrow, ncol) planes_defl hierarchy cost ~2.7 GB
    # at 8192² and pushed the solve over the one-chip HBM edge
    # (measured OOM by 211 MB), while the labels are already resident
    # for the zaz build and the masked apply fuses.
    labels: jax.Array   # (nrow, ncol) int32 island labels
    notb: jax.Array     # (nrow, ncol) 1.0 where NOT Dirichlet
    dinv: jax.Array     # (nrow, ncol) 1/sum_d W_d (0 where D == 0)
    lidx: jax.Array     # (T, C) int16 tile-local slot per cell
    slot_iota: jax.Array  # (Ld,) int16 arange (adaptive dense width)
    sidx: jax.Array     # (S,) active-slot flat indices
    sisland: jax.Array  # (S,) island id per active slot
    ocell: jax.Array    # (O,) overflow-cell flat tile-major indices
    oisland: jax.Array  # (O,) island id per overflow cell
    zaz_inv: jax.Array  # (num,) 1/(z_I^T A z_I); index 0 unused

    @property
    def shape(self):
        return self.planes.shape[-2:]


def island_zaz(planes: jax.Array, labels: jax.Array, lidx: jax.Array,
               slot_iota: jax.Array,
               sidx: jax.Array, sisland: jax.Array,
               num_segments: int, ocell: jax.Array,
               oisland: jax.Array) -> jax.Array:
    """z_I^T A z_I = total leak weight out of each island: the sum of
    W edges from island cells to cells with a different label (one tiled
    segsum over the summed cross-edge planes)."""
    lab = jnp.asarray(labels, jnp.int32)
    nrow, ncol = lab.shape
    labpad = jnp.pad(lab, 1, constant_values=-1)
    total = jnp.zeros(lab.shape, jnp.float32)
    for k, (dr, dc) in enumerate(_DELTAS):
        nb = jax.lax.slice(labpad, (dr + 1, dc + 1),
                           (dr + 1 + nrow, dc + 1 + ncol))
        cross = (lab > 0) & (nb != lab)
        total = total + jnp.where(cross, planes[k], 0.)
    zaz = _tile_segsum(total, lidx, slot_iota, sidx, sisland,
                       num_segments, ocell, oisland)
    zaz = zaz.at[0].set(1.0)  # background: never used
    return jnp.maximum(zaz, 1e-30)


def _apply_lap_crossing(planes: jax.Array, labels: jax.Array,
                        u: jax.Array) -> jax.Array:
    """A u through CROSSING edges only: island-internal edge terms
    (label > 0 on both endpoints, same label) are zeroed in the fused
    apply loop (see ``LapLevel.labels``). Edges from/to background
    (label 0) and between different labels are kept."""
    lab = jnp.asarray(labels, jnp.int32)
    nrow, ncol = u.shape
    labpad = jnp.pad(lab, 1, constant_values=-1)
    upad = jnp.pad(u, 1)
    acc = jnp.zeros_like(u)
    for k, (dr, dc) in enumerate(_DELTAS):
        nb_lab = jax.lax.slice(labpad, (dr + 1, dc + 1),
                               (dr + 1 + nrow, dc + 1 + ncol))
        nb = jax.lax.slice(upad, (dr + 1, dc + 1),
                           (dr + 1 + nrow, dc + 1 + ncol))
        internal = (lab > 0) & (nb_lab == lab)
        acc = acc + jnp.where(internal, 0., planes[k]) * (u - nb)
    return acc


def _constrain_rows(x: jax.Array, fs, axis: int) -> jax.Array:
    """``with_sharding_constraint`` pinning ``axis`` of ``x`` to the
    'rows' mesh axis of NamedSharding ``fs`` — a no-op when ``fs`` is
    None or the axis is too small/uneven to split. Used by the spatially
    sharded solve (parallel/fields.py): without explicit per-level
    constraints GSPMD replicates every level below the finest (measured:
    an ncells/2 all-gather at the level-0/1 prolongation), which at
    8192²-class grids would replicate the level-1 planes (and, before
    round 3's COO deflation, GB-scale tile one-hots) and defeat the
    point of sharding."""
    if fs is None:
        return x
    n = fs.mesh.devices.size
    if x.shape[axis] % n != 0 or x.shape[axis] < 2 * n:
        return x
    from jax.sharding import NamedSharding, PartitionSpec
    spec = [None] * x.ndim
    spec[axis] = 'rows'
    return jax.lax.with_sharding_constraint(
        x, NamedSharding(fs.mesh, PartitionSpec(*spec)))


def build_lap_levels(planes: jax.Array, bmask: jax.Array,
                     tiles: Sequence[TileSeg],
                     num_segments: int,
                     field_sharding=None) -> List[LapLevel]:
    """Static level hierarchy (shapes fixed at trace time); the number of
    levels is ``len(tiles)`` (host-computed with the same min-size rule).
    Pure jnp apart from the host-prepared tile structures: the whole
    hierarchy build runs inside the solve jit. ``field_sharding`` (a
    row NamedSharding or None) pins each level's big arrays to the mesh
    (see _constrain_rows)."""
    fs = field_sharding
    levels = []
    mask = jnp.asarray(bmask, bool)
    for i, ts in enumerate(tiles):
        assert planes.shape[-2:] == ts.labels.shape, \
            (planes.shape, ts.labels.shape)
        planes = _constrain_rows(planes, fs, 1)
        lidx = ts.lidx
        if fs is not None:
            # the tile axis T = tr*tc is row-major over the tile grid:
            # sharding it matches field rows only when tr divides evenly
            tr = _tiled_dims(ts.labels.shape)[0] // _TILE
            if tr % fs.mesh.devices.size == 0:
                lidx = _constrain_rows(lidx, fs, 0)
        diag = jnp.sum(planes, axis=0)
        dinv = jnp.where(diag > 0., 1. / jnp.where(diag > 0., diag, 1.), 0.)
        zaz = island_zaz(planes, ts.labels, lidx, ts.slot_iota,
                         ts.sidx, ts.sisland,
                         num_segments, ts.ocell, ts.oisland)
        levels.append(LapLevel(
            planes=planes,
            labels=_constrain_rows(jnp.asarray(ts.labels, jnp.int32),
                                   fs, 0),
            notb=_constrain_rows((~mask).astype(jnp.float32), fs, 0),
            dinv=_constrain_rows(dinv, fs, 0),
            lidx=lidx, slot_iota=ts.slot_iota,
            sidx=ts.sidx, sisland=ts.sisland,
            ocell=ts.ocell, oisland=ts.oisland,
            zaz_inv=(1.0 / zaz).astype(jnp.float32)))
        if i + 1 < len(tiles):
            planes = _galerkin_coarsen(planes)
            mask = _coarsen_bmask(mask)
    return levels


def _smooth(level: LapLevel, u: jax.Array, rhs: jax.Array, omega: float,
            nsweeps: int) -> jax.Array:
    """Damped diagonally-scaled Jacobi on the difference form."""
    def body(_, u):
        r = rhs - _apply_lap(level.planes, u)
        return u + (omega * level.notb * level.dinv) * r
    return jax.lax.fori_loop(0, nsweeps, body, u)


def _deflate(level: LapLevel, u: jax.Array, rhs: jax.Array) -> jax.Array:
    """Island-subspace correction at this level:
    ``u += z_I (z_I^T r)/(z_I^T A z_I)`` for every island. Applied at
    EVERY level of the cycle: island-level modes whose wavelength spans
    many islands are only multigrid-convergent if the coarse grids can
    move island levels too (measured: fine-level-only deflation leaves a
    ~0.99/cycle stall on 100+-island fields). The tile matmuls run f32 at
    HIGHEST precision: the correction divides by zaz ~ 1e-8, amplifying
    sum errors ~1e8x (bf16 pushed final residuals 1e-7 -> 3e-4).

    The residual for the island sums goes through CROSSING edges only
    (``_apply_lap_crossing``) — identical island sums in exact
    arithmetic, but free of the f32 internal-strong-edge cancellation
    noise that the 1/zaz division amplifies into O(10)-potential-unit
    poison (see LapLevel.labels)."""
    r = (rhs - _apply_lap_crossing(level.planes, level.labels, u)) \
        * level.notb
    num = level.zaz_inv.shape[0]
    rsum = _tile_segsum(r, level.lidx, level.slot_iota, level.sidx,
                        level.sisland,
                        num, level.ocell, level.oisland)
    c = (rsum * level.zaz_inv).at[0].set(0.)
    upd = _tile_broadcast(c, level.lidx, level.slot_iota, level.sidx,
                          level.sisland,
                          level.shape, level.ocell, level.oisland)
    return u + upd * level.notb


def vcycle(levels: List[LapLevel], rhs: jax.Array, u0: jax.Array,
           omega: float = 0.85, nu1: int = 2, nu2: int = 2,
           coarse_sweeps: int = 32, kappa: float = 2.0,
           field_sharding=None) -> jax.Array:
    """One deflated V-cycle for A u = rhs with u clamped (= 0 correction)
    at Dirichlet cells; recursion unrolled at trace time.

    ``kappa`` over-corrects the prolongated coarse update: the
    piecewise-constant-aggregated Galerkin operator is ~2x too stiff for
    smooth modes (their energy concentrates at aggregate jumps), and
    kappa = 2 compensates — measured on a uniform field at 460x460,
    asymptotic rate 0.91 (kappa 1) -> 0.69 (kappa 2).

    ``field_sharding`` pins the inter-level transfer outputs to the row
    mesh (the transfers contract the sharded axis, where GSPMD otherwise
    prefers to gather; see _constrain_rows)."""
    fs = field_sharding

    def cycle(idx: int, u: jax.Array, rhs: jax.Array) -> jax.Array:
        level = levels[idx]
        if idx == len(levels) - 1:
            u = _smooth(level, u, rhs, omega, coarse_sweeps)
            return _deflate(level, u, rhs)
        u = _smooth(level, u, rhs, omega, nu1)
        u = _deflate(level, u, rhs)
        r = (rhs - _apply_lap(level.planes, u)) * level.notb
        coarse = levels[idx + 1]
        r_c = _constrain_rows(_restrict(r), fs, 0) * coarse.notb
        e_c = cycle(idx + 1, jnp.zeros(coarse.shape, r.dtype), r_c)
        pe = _constrain_rows(_prolong_pc(e_c, level.shape), fs, 0)
        u = u + kappa * pe * level.notb
        u = _deflate(level, u, rhs)
        return _smooth(level, u, rhs, omega, nu2)

    return cycle(0, u0, rhs)


# ---- island labeling (host, once per solve) ---------------------------------


def island_labels(conductivity: np.ndarray, bmask: np.ndarray,
                  weak: bool = False) -> Tuple[np.ndarray, int]:
    """Label the near-decoupled components whose levels are near-null
    modes (host side, once per solve).

    Two families, both deflated by the same tile machinery:

    - *Floating strong islands*: a component of ``cond > 0``
      (8-connectivity, matching the stencil) is *anchored* — and
      excluded — when it contains or touches a Dirichlet cell that
      itself has ``cond > 0``: such a component couples to the boundary
      through O(1) harmonic means and is not ill-conditioned.
    - *Weak plateaus* (``weak=True``, experimental opt-in): components
      of ``cond <= 0`` (the thresholded-updraft zero regions). Every
      edge of a plateau cell is at the ~1e-8 conductivity floor, so the
      plateau's mean level is a near-null mode even when the component
      touches the Dirichlet boundary. Measured (round 3): deflating
      them inside the V-cycle did NOT improve the production GCR
      (asymptotic rate 0.846 -> 0.924 at 460^2 on the hard speckle
      class) — the D^-1-metric GCR already grinds plateau levels, and
      the extra per-level projections steal components the cycle
      handles better. Kept as an opt-in for solver experiments.

    Returns (labels int32 (nrow, ncol), 0 = anchored strong background,
    1..K floating islands then weak plateaus; K).
    """
    from scipy import ndimage
    pos = np.asarray(conductivity)
    # a bool input is an already-computed strong mask (the device-
    # resident prep pulls cond > 0 as packed bits instead of the full
    # f32 field — see strong_mask_host)
    pos = pos if pos.dtype == np.bool_ else pos > 0.
    bmask = np.asarray(bmask, bool)
    structure = np.ones((3, 3), bool)
    lab, nlab = ndimage.label(pos, structure=structure)
    strong_anchor = ndimage.binary_dilation(bmask & pos, structure=structure)
    anchored = np.unique(lab[strong_anchor & (lab > 0)])
    # O(N) vectorized relabel: anchored/background -> 0, floating islands
    # -> consecutive 1..K (a per-label Python loop is O(K*N) and takes
    # minutes at 23k islands on a 4096^2 grid).
    keep = np.ones(nlab + 1, bool)
    keep[0] = False
    keep[anchored] = False
    newid = np.where(keep, np.cumsum(keep), 0).astype(np.int32)
    labels = newid[lab]
    k = int(keep.sum())
    if weak:
        labw, nw = ndimage.label((~pos) & ~bmask, structure=structure)
        labels = np.where(labw > 0, labw + k, labels).astype(np.int32)
        k += int(nw)
    return labels, k


# ---- driver -----------------------------------------------------------------


_GCR_K = 3  # truncated-GCR history depth (Orthomin(k))


def _gcr_solve(levels: List[LapLevel], rhs: jax.Array, maxiter,
               tol_abs, field_sharding=None) -> jax.Array:
    """Solve A x = rhs (x clamped 0 at Dirichlet) by truncated flexible
    GCR preconditioned with one deflated V-cycle per iteration.

    Stationary deflated cycles alone stall at ~0.99/cycle on large
    many-island fields (measured at 460x460: the leftover slow modes are
    long-wavelength plateau/island-level combinations that neither
    piecewise-constant coarse grids nor per-island deflation represent);
    a k=3 Krylov history restores fast, roughly mesh-independent
    convergence (~0.8/iteration on the same field). Inner products are
    taken in the D^-1-weighted norm so plateau rows (D ~ 1e-8) are not
    invisible next to island rows (D ~ 1).
    """
    top = levels[0]
    notb = top.notb
    dinv2 = top.dinv * top.dinv

    def sdot(a, b):
        # HIGHEST: a TF32 inner product would corrupt the GCR
        # orthogonalization
        return jnp.vdot(a * dinv2, b, precision=_HI)

    def snorm(r):
        return jnp.linalg.norm(r * top.dinv)

    x0 = jnp.zeros_like(rhs)
    buf = _constrain_rows(jnp.zeros((_GCR_K,) + rhs.shape, rhs.dtype),
                          field_sharding, 1)

    def body(carry):
        x, Z, Q, it, _, rn_prev = carry
        r = (rhs - _apply_lap(top.planes, x)) * notb
        z = vcycle(levels, r, jnp.zeros_like(x),
                   field_sharding=field_sharding) * notb
        q = _apply_lap(top.planes, z) * notb

        def ortho(i, zq):
            z, q = zq
            beta = sdot(q, Q[i])
            return z - beta * Z[i], q - beta * Q[i]

        z, q = jax.lax.fori_loop(0, _GCR_K, ortho, (z, q))
        nrm2 = sdot(q, q)
        inv = jnp.where(nrm2 > 0, jax.lax.rsqrt(nrm2 + 1e-38), 0.)
        z, q = z * inv, q * inv
        alpha = sdot(r, q)
        x = x + alpha * z
        Z = jnp.concatenate([Z[1:], z[None]])
        Q = jnp.concatenate([Q[1:], q[None]])
        rn_old = carry[4]
        rn = snorm((rhs - _apply_lap(top.planes, x)) * notb)
        return x, Z, Q, it + 1, rn, rn_old

    def cond(carry):
        x, Z, Q, it, rn, rn_prev = carry
        # Exit at the f32 floor. The threshold must sit between the
        # slow-start rate (~0.97/iter for the first ~6 iterations on hard
        # fields — a 2% threshold killed refinement passes mid-start,
        # measured rrel 3e-5 vs 1e-7) and the floor bounce (rate ~1.0).
        improving = (rn < 0.995 * rn_prev) | (it < 8)
        return (it < maxiter) & (rn > tol_abs) & improving

    init = (x0, buf, buf, jnp.asarray(0, jnp.int32),
            snorm(rhs), jnp.float32(jnp.inf))
    x, _, _, _, rn, _ = jax.lax.while_loop(cond, body, init)
    return x, rn


def island_sound_mask(labels_np: np.ndarray, num: int) -> np.ndarray:
    """Per-island indicator (f32, length ``num``) of islands whose
    edges are ALL genuinely symmetric — i.e. islands that never occupy
    the two easternmost columns, where the reference's east-column fac
    quirk makes W nonsymmetric (see symmetrize_planes). Only for these
    is the outer island correction's coefficient
    ``z^T r / z^T A z`` a sound orthogonal projection; for strip
    islands it is an oblique projection that genuinely explodes
    (measured c ~ 2e6) and stalls the refinement, so they are left to
    the symmetrized per-level deflation + GCR. Index 0 (anchored
    background) is 0."""
    sound = np.zeros(num, np.float32)
    k = int(labels_np.max())
    if k:
        strip = np.unique(labels_np[:, -2:])
        sound[1:k + 1] = 1.0
        sound[strip[strip > 0]] = 0.0
    return sound


def _solve_refined_core(conductivity, bmask, bvals, tiles, sound,
                        num_segments: int,
                        tol: float, maxcycles: int, refine: int,
                        field_sharding=None, init=None):
    bmask = jnp.asarray(bmask, bool)
    bvals = jnp.asarray(bvals, jnp.float32)
    planes_t = weight_planes(conductivity)
    planes_s = symmetrize_planes(planes_t)
    # preconditioner hierarchy on the SYMMETRIZED operator (sound
    # deflation; see symmetrize_planes); refinement residuals below use
    # the TRUE planes, so the solution solves the reference's system.
    # Both plane stacks stay materialized: the factored low-memory
    # alternative broke the DS error-free transforms under fusion (see
    # the strip-skew negative-result note above _pad_even).
    planes_t = _constrain_rows(planes_t, field_sharding, 1)
    levels = build_lap_levels(planes_s, bmask, tiles,
                              num_segments, field_sharding=field_sharding)
    top = levels[0]
    notb = top.notb
    u0_cold = jnp.where(bmask, bvals, 500.)
    if init is None:
        u0 = u0_cold
    else:
        # warm start (e.g. the previous direction's potential in a
        # sweep — an unmaterialized device array chains solves without
        # a host sync). Sanitized so a pathological prior solve can
        # only cost iterations, never poison this one.
        u0 = jnp.where(bmask, bvals,
                       jnp.where(jnp.isfinite(init), init, 500.))

    # All norms are of the diagonally-SCALED residual D^-1 r: in plateau
    # rows (D ~ 8e-8) and island rows alike, the error has sensitivity
    # ~1/D to the raw residual, so an unscaled norm exits with O(100)
    # errors hiding behind 1e-6 residual entries (measured during
    # development). D^-1 r is in potential units.
    def scaled_norm(r_hi):
        return jnp.linalg.norm(r_hi * top.dinv)

    # convergence is always judged relative to the COLD start's
    # residual, so tol/rrel semantics (and the 5e-3 fallback policy
    # threshold) are identical with and without a warm start
    scale = scaled_norm(-_apply_lap(planes_t, u0_cold) * notb) + 1e-30
    target = tol * scale
    # island level-error estimate |z^T r| / (z^T A z), potential units
    lev_target = jnp.float32(1e-4)
    num = num_segments

    def island_coeff(r_hi):
        """Sound-island level-error estimates z^T r / z^T A z. Masked
        to SOUND islands (island_sound_mask): for east-strip islands
        the quotient is oblique (wrong magnitude by orders), so they
        are neither corrected nor used as a convergence criterion —
        their levels converge through the residual norm like any other
        mode, down to the f32 floor (docs/DESIGN.md round-3
        "east-strip deflation stall": Altamont max err 8.9/1000 at one
        strip island, the measured floor)."""
        rsum = _tile_segsum(r_hi, top.lidx, top.slot_iota, top.sidx,
                            top.sisland,
                            num, top.ocell, top.oisland)
        return (rsum * top.zaz_inv * sound).at[0].set(0.)

    def island_correction(uds, r_hi):
        """Outer subspace correction u += z_I c_I over SOUND islands
        (DS-accurate residual sums, f32-exact tile matmuls). This is
        load-bearing off the strip: without it the sound-island levels
        and the global smooth mode they carry stall the refinement at
        rrel ~5e-4 with O(100) errors (measured on the 460^2 hard
        speckle field when it was dropped entirely)."""
        c = island_coeff(r_hi)
        upd = _tile_broadcast(c, top.lidx, top.slot_iota, top.sidx,
                              top.sisland,
                              top.shape, top.ocell, top.oisland)
        return ds_add(uds, ds_from(upd * notb))

    # Double-single refinement from u0; the FIRST pass plays the classic
    # "stage 1" role (its DS residual of the f32 start IS the plain f32
    # residual), so there is only ONE _gcr_solve/vcycle trace in the
    # graph — a separate f32 stage doubled the traced solver body and
    # with it the XLA compile time at large shapes. Sound-island
    # levels are corrected LAST in each pass (island_correction), so the
    # exit state has exact levels there up to DS residual accuracy;
    # strip-island levels ride the residual norm to the f32 floor.
    uds = DS(u0, jnp.zeros_like(u0))

    def ds_resid(uds):
        r = apply_lap_ds(planes_t, uds)
        return -(r.hi + r.lo) * notb

    def ref_cond(carry):
        uds, it, rnorm, lev, rn_best, stall = carry
        unconverged = (rnorm > target) | (lev > lev_target)
        # Pass-over-pass stall guard: exit once no pass in the last 3
        # has set a new best (<=0.9x) scaled residual. The guard tracks
        # the BEST rather than the previous pass because the outer
        # true-operator refinement around the symmetrized preconditioner
        # converges non-monotonically on east-strip-island fields
        # (measured: rrel bounces 0.02 -> 0.09 between passes on the way
        # to 1e-7); a previous-pass guard killed those solves mid-flight,
        # while genuinely floored solves still exit within 3 passes.
        return (it < refine) & unconverged & (stall < 3)

    def ref_body(carry):
        uds, it, rn_old, _, rn_best, stall = carry
        r_hi = ds_resid(uds)
        # Long inner budget, few passes: GCR momentum builds over ~6
        # iterations before the asymptotic ~0.86/iter rate kicks in on
        # hard fields, so restarting every 8 iterations spends every pass
        # in the slow-start phase (measured: 0.97/iter across 8-iter
        # passes vs 0.86/iter continuous). The stall guard in _gcr_solve
        # exits early once the f32 floor is hit.
        delta, _ = _gcr_solve(levels, r_hi, maxcycles,
                              jnp.maximum(0.02 * scaled_norm(r_hi),
                                          jnp.float32(0.5) * target),
                              field_sharding=field_sharding)
        uds = ds_add(uds, ds_from(delta * notb))
        r_hi = ds_resid(uds)
        # Outer island correction over SOUND islands only (see
        # island_correction/island_sound_mask). Correcting east-strip
        # islands here used the oblique coefficient
        # z^T r_true / z^T A_sym z, which overshoots by orders of
        # magnitude and made the refinement bounce without converging
        # (measured round 3: masking them took the (41,90)@0.5 fuzz
        # stall field from rrel 0.24 stalled to converged, and the
        # Altamont verify-flow field from rrel 5e-3 to ~5e-8), while
        # dropping the correction for ALL islands stalled the 460^2
        # hard speckle field at rrel 5e-4 with O(100) errors.
        uds = island_correction(uds, r_hi)
        r_hi = ds_resid(uds)
        lev = jnp.max(jnp.abs(island_coeff(r_hi)))
        rn = scaled_norm(r_hi)
        improved = rn < 0.9 * rn_best
        stall = jnp.where(improved, 0, stall + 1)
        rn_best = jnp.minimum(rn_best, rn)
        return uds, it + 1, rn, lev, rn_best, stall

    uds, nref, rn2, _, _, _ = jax.lax.while_loop(
        ref_cond, ref_body,
        (uds, jnp.asarray(0, jnp.int32), scale, jnp.float32(jnp.inf),
         scale, jnp.asarray(0, jnp.int32)))

    out = uds.hi + uds.lo
    out = jnp.where(bmask, bvals, out)
    return out.astype(jnp.float32), rn2 / scale


_solve_refined_jit = functools.partial(
    jax.jit, static_argnames=('maxcycles', 'refine', 'tol',
                              'num_segments', 'field_sharding')
)(_solve_refined_core)


@functools.partial(jax.jit,
                   static_argnames=('maxcycles', 'refine', 'tol',
                                    'num_segments'))
def _solve_refined_batch_jit(conductivity, bmask, bvals, tiles, sound,
                             num_segments: int,
                             tol: float, maxcycles: int, refine: int):
    """vmap of the refined solve over a leading case axis: C cases
    advance in ONE program, so the many small per-level ops that leave
    the chip idle at small grids carry C cases' work each. bmask/bvals
    are shared (one track direction); the per-case while_loops run to
    the max over the batch with converged cases masked (standard vmap
    batching of lax.while_loop), so results match the single-case solve
    up to f32 reduction-order noise in the padded tile routing."""
    def core(c, ts, sn):
        return _solve_refined_core(c, bmask, bvals, ts, sn,
                                   num_segments, tol, maxcycles, refine,
                                   None)
    return jax.vmap(core)(conductivity, tiles, sound)


def solve_potential_refined_batch(conductivities, bmask, bvals,
                                  tol: float = 1e-7,
                                  maxcycles: int = 60, refine: int = 30):
    """Batched multi-case refined solve: one vmapped program for C
    conductivity fields sharing a grid and track direction. Returns
    (potentials (C, nrow, ncol) f32 device array, residuals (C,)) —
    both UNMATERIALIZED (async dispatch, like solve_potential_refined).

    Status (round 5): NOT the production default. The round-4 "~3x at
    500x600" measurement does not reproduce — interleaved A/Bs now
    measure this path LOSING to pipelined sequential solves at every
    grid tried (3.4x at 500x600), and its convergence is
    composition-fragile on ill-conditioned fields: cases that solve to
    3e-7 alone exit at 3e-3 inside batches >= 4 (still under the 5e-3
    safety net; per-pass iterates match solo to ~1e-4, so the
    divergence is f32 trajectory sensitivity amplified by the stall
    guards, not a routing bug — the one routing hazard found, the
    unrestrided ``sidx`` under mixed adaptive widths, is fixed and
    tested but was NOT the cause here). Kept for explicit opt-in
    (Config.potential_batch > 1) and as the measured record;
    docs/DESIGN.md "Round 5: the batched-solve reversal". The per-case
    island buckets are padded to the batch maxima (see
    _stack_tile_hierarchies); num_segments is the max power-of-4
    bucket across cases."""
    conds = [np.asarray(c) for c in conductivities]
    shape = conds[0].shape
    assert all(c.shape == shape for c in conds)
    bmask_np = np.asarray(bmask, bool)
    labels = []
    num = 256
    for c in conds:
        lab, k = island_labels(c, bmask_np)
        labels.append(lab)
        while num < k + 1:
            num *= 4
    hiers = [_build_tile_hierarchy_host(lab, bmask_np) for lab in labels]
    tiles = jax.device_put(_stack_tile_hierarchies(hiers))
    sound = np.stack([island_sound_mask(lab, num) for lab in labels])
    return _solve_refined_batch_jit(
        jnp.asarray(np.stack(conds), jnp.float32),
        jnp.asarray(bmask_np), jnp.asarray(bvals, jnp.float32),
        tiles, jnp.asarray(sound), num, tol, maxcycles, refine)


@jax.jit
def _packed_strong_mask(conductivity):
    return jnp.packbits((conductivity > 0.).reshape(-1))


def strong_mask_host(conductivity) -> np.ndarray:
    """Host bool ``conductivity > 0`` mask for island labeling.

    For a DEVICE-resident conductivity this pulls only packed bits
    (N/8 bytes instead of 4N — the labeling is the one host consumer of
    a multi-case prep's conductivities, and the full-field pull was the
    measured bound of the Appalachian sweep's updraft phase: ~160 MB /
    9.6 s for 24 cases, docs/DESIGN.md "Round 5: the Appalachian
    end-to-end"). Host arrays take the plain comparison."""
    if isinstance(conductivity, jax.Array) and \
            not isinstance(conductivity, np.ndarray):
        shape = conductivity.shape
        packed = np.asarray(_packed_strong_mask(conductivity))
        n = int(np.prod(shape))
        return np.unpackbits(packed, count=n).astype(bool).reshape(shape)
    return np.asarray(conductivity) > 0.


def solve_potential_refined(conductivity, bmask, bvals, tol: float = 1e-7,
                            maxcycles: int = 60, refine: int = 30,
                            init=None):
    """Solve the reference directional-potential system on device to f64-
    oracle accuracy (validated in tests/test_potential.py). Returns
    (potential float32 (nrow, ncol), relative residual scalar).

    Host work per solve is one ``scipy.ndimage.label`` pass plus the
    vectorized tile-dictionary build; the weight planes, the whole
    Galerkin hierarchy, and the solve run in a single jit (compiled once
    per (shape, island-bucket, slot-bucket) tuple). ``conductivity``
    may be a device array: only its packed cond>0 bits are pulled to
    host (strong_mask_host) and the field itself feeds the jit without
    a host round trip. ``init`` optionally warm-starts the refinement
    (convergence is still judged against the cold start's residual, so
    rrel semantics are unchanged); an unmaterialized device array —
    e.g. the previous direction's potential in a sweep — chains solves
    without a host sync."""
    bmask_np = np.asarray(bmask, bool)
    labels_np, k = island_labels(strong_mask_host(conductivity), bmask_np)
    # quantize the segment count in powers of 4 so recompiles are rare
    # across fields (num only sizes (num,)-length vectors)
    num = 256
    while num < k + 1:
        num *= 4
    tiles = build_tile_hierarchy(labels_np, bmask_np)
    return _solve_refined_jit(
        jnp.asarray(conductivity, jnp.float32), jnp.asarray(bmask_np),
        jnp.asarray(bvals, jnp.float32), tiles,
        jnp.asarray(island_sound_mask(labels_np, num)), num,
        tol, maxcycles, refine, None, init)
