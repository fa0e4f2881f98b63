"""Plain float64 references for a whole SSRS study.

Written from the reference formulas (NREL/SSRS ``ssrs/layers.py`` and
``ssrs/movmodel.py``) with NumPy and SciPy only: nothing here imports
``ssrs_tpu``. Each function is the straightforward form of one stage:

- Horn slope/aspect and the Brandes-Ombalski orographic updraft;
- the usable-updraft threshold transform;
- the directional-potential linear system and its SuperLU solve;
- the per-cell move-weight table (harmonic-mean lift x potential drop);
- the circular presence smoothing and the summary presence map;
- the stochastic track walk, vectorized over agents with NumPy's RNG.

``lower=True`` on a stage computes it one precision step below the one
the configuration states (bfloat16 for float32 fields, float32 for the
float64 solve). That is the control of the correctness check: put in the
program's place, it has to read as not correct.
"""

from __future__ import annotations

from math import ceil, floor

import ml_dtypes
import numpy as np
import scipy.signal
import scipy.sparse as sp
import scipy.sparse.linalg as spla

BF16 = ml_dtypes.bfloat16

# move m <-> (dr, dc) = (m // 3 - 1, m % 3 - 1); the centre (no move) is 4
DELTAS = np.array([[m // 3 - 1, m % 3 - 1] for m in range(9)])
STEP_LEN = np.hypot(DELTAS[:, 0], DELTAS[:, 1])
INV_STEP = np.where(STEP_LEN > 0, 1. / np.where(STEP_LEN == 0, 1, STEP_LEN),
                    0.)
NOT_CENTRE = np.ones(9)
NOT_CENTRE[4] = 0.


def _bf16(x):
    """Round to bfloat16 and back: one stage of the lower-precision
    control."""
    return np.asarray(x, np.float32).astype(BF16).astype(np.float64)


# ---- fields ---------------------------------------------------------------

def slope_aspect(z, res, lower=False):
    """Horn 3x3 slope and aspect in degrees (axis 0 is the reference's
    'x'); border cells zero."""
    r = _bf16 if lower else (lambda a: a)
    z = r(np.asarray(z, np.float64))
    nrow, ncol = z.shape
    gx = np.zeros_like(z)
    gy = np.zeros_like(z)
    for w, off in zip((1., 2., 1.), (-1, 0, 1)):
        gx[1:-1, 1:-1] += w * (z[2:, 1 + off:ncol - 1 + off]
                               - z[:-2, 1 + off:ncol - 1 + off])
        gy[1:-1, 1:-1] += w * (z[1 + off:nrow - 1 + off, 2:]
                               - z[1 + off:nrow - 1 + off, :-2])
    gx = r(gx / (8. * res))
    gy = r(gy / (8. * res))
    slope = r(np.degrees(np.arctan(np.hypot(gx, gy))))
    gxi = np.where(gx == 0., 1e-10, gx)
    aspect = r(180. - np.degrees(np.arctan(gy / gxi)) + 90. * np.sign(gxi))
    for a in (slope, aspect):
        a[0, :] = a[-1, :] = 0.
        a[:, 0] = a[:, -1] = 0.
    return slope, aspect


def orographic_updraft(speed, dirn, slope, aspect, lower=False):
    """w = speed * sin(slope) * max(cos(aspect - dirn), 0), floored at 0."""
    r = _bf16 if lower else (lambda a: a)
    lift = r(np.cos(np.radians(aspect - dirn)).clip(min=0.))
    return r((r(speed * np.sin(np.radians(slope))) * lift).clip(min=0.))


def threshold(w, thr):
    """Usable updraft: 0 below 1e-2, the exponential blend up to the
    threshold, w above it."""
    w = np.asarray(w, np.float64)
    with np.errstate(over='ignore'):
        blend = thr * np.expm1((w / thr) ** 5) / (np.e - 1.)
    return np.where(w > 1e-2, np.where(w > thr, w, blend), 0.)


# ---- directional potential -----------------------------------------------

def boundary_nodes(move_dirn, shape):
    """Dirichlet perimeter nodes (column-major numbering) and their
    values: the low (0) and high (1000) sets split by the movement
    quadrant, at half the concatenated list (the reference's split)."""
    nrow, ncol = shape
    north = nrow * (np.arange(ncol) + 1) - 1
    south = nrow * np.arange(ncol)
    west = np.arange(1, nrow - 1)
    east = (ncol - 1) * nrow + np.arange(1, nrow - 1)
    angle = move_dirn % 90.
    quad = (move_dirn % 360) // 90.
    ncl = round(ncol * angle / 90.)
    nrl = round(nrow * angle / 90.)
    if quad == 0:
        low = np.concatenate((north[ncl:], east[nrow - nrl:]))
        high = np.concatenate((south[:ncol - ncl], west[:nrl]))
    elif quad == 1:
        low = np.concatenate((south[ncol - ncl:], east[:nrow - nrl]))
        high = np.concatenate((north[:ncl], west[nrl:]))
    elif quad == 2:
        low = np.concatenate((south[:ncol - ncl], west[:nrl]))
        high = np.concatenate((north[ncl:], east[nrow - nrl:]))
    else:
        high = np.concatenate((south[ncol - ncl:], east[:nrow - nrl]))
        low = np.concatenate((north[:ncl], west[nrl:]))
    nodes = np.concatenate((low, high)).astype(np.int64)
    vals = np.zeros(nodes.size)
    vals[nodes.size // 2:] = 1000.
    return nodes, vals


def potential_system(cond):
    """Row-normalized neighbour graph P of the conductivity field: edge
    weight harmonic_mean(c_i, c_j) (1e-8 where either is 0) over the step
    length, in column-major node order. The reference's neighbour list
    alternates 1 and sqrt(2) by list position, which on the east column
    gives the northward edge sqrt(2) and the north-west edge 1."""
    cond = np.asarray(cond, np.float64)
    nrow, ncol = cond.shape
    rr, cc = np.meshgrid(np.arange(nrow), np.arange(ncol), indexing='ij')
    node = cc * nrow + rr
    ii, jj, ww = [], [], []
    for dr, dc in DELTAS:
        if dr == 0 and dc == 0:
            continue
        ok = ((rr + dr >= 0) & (rr + dr < nrow)
              & (cc + dc >= 0) & (cc + dc < ncol))
        ca = cond[ok]
        cb = cond[(rr + dr)[ok], (cc + dc)[ok]]
        both = (ca != 0) & (cb != 0)
        with np.errstate(divide='ignore', invalid='ignore'):
            hm = np.where(both, 2. / (1. / ca + 1. / cb), 1e-8)
        fac = np.full(hm.shape, np.sqrt(2.) if dr and dc else 1.)
        east = (cc[ok] == ncol - 1) & (rr[ok] > 0) & (rr[ok] < nrow - 1)
        if (dr, dc) == (-1, 0):
            fac[east] = np.sqrt(2.)
        elif (dr, dc) == (-1, -1):
            fac[east] = 1.
        ii.append(node[ok])
        jj.append(((cc + dc) * nrow + rr + dr)[ok])
        ww.append(hm / fac)
    n = nrow * ncol
    g = sp.csr_matrix((np.concatenate(ww),
                       (np.concatenate(ii), np.concatenate(jj))),
                      shape=(n, n))
    return sp.diags(1. / np.asarray(g.sum(axis=1)).ravel()) @ g


def solve_potential(cond, move_dirn, lower=False):
    """Directional potential: (I - P_ii) x_i = P_ib b by SuperLU, in
    float64 (float32 for the control). Returns (nrow, ncol) float64."""
    nrow, ncol = np.shape(cond)
    n = nrow * ncol
    bnodes, bvals = boundary_nodes(move_dirn, (nrow, ncol))
    p = potential_system(cond).tocsr()
    inner = np.setdiff1d(np.arange(n), bnodes, assume_unique=True)
    p_in = p[inner]
    a = (sp.eye(inner.size, format='csr') - p_in[:, inner]).tocsc()
    rhs = p_in[:, bnodes] @ bvals
    dt = np.float32 if lower else np.float64
    x = spla.spsolve(a.astype(dt), rhs.astype(dt))
    full = np.empty(n)
    full[inner] = x
    full[bnodes] = bvals
    return full.reshape(ncol, nrow).T


# ---- move model -----------------------------------------------------------

def directional_prior(move_dirn):
    """Prior over the 9 moves: cos of the angle between the move and the
    heading (clockwise from north, +row is north), zero below 0.01."""
    th = np.radians(move_dirn)
    heading = np.array([np.cos(th), np.sin(th)])
    out = np.zeros(9)
    for m, (dr, dc) in enumerate(DELTAS):
        if dr or dc:
            c = float(np.array([dr, dc]) @ heading / np.hypot(dr, dc))
            out[m] = c if c >= 0.01 else 0.
    return out


def restriction_masks():
    """(9, 9) allowed-move masks after each previous move (reference
    ``get_track_restrictions``, with its ``abs(dr + dc % 2)``
    precedence); row 4 (no previous move) allows every move but the
    centre."""
    out = np.zeros((9, 9))
    for m, (dr, dc) in enumerate(DELTAS):
        a = np.zeros((3, 3))
        if dr == 0 and dc == 0:
            a[:, :] = 1
        elif abs(dr + dc % 2) == 1:
            if dr == 0:
                a[:, dc + 1] = 1
            else:
                a[dr + 1, :] = 1
        else:
            rows = np.zeros((3, 3), bool)
            cols = np.zeros((3, 3), bool)
            rows[[dr + 1, 1], :] = True
            cols[:, [1, dc + 1]] = True
            a = (rows & cols).astype(float)
        a[1, 1] = 0
        out[m] = a.ravel()
    return out


def weight_table(cond, potential, prior):
    """(nrow*ncol, 9) move weights: harmonic mean of the updraft at the
    cell and the neighbour (floored at 1e-6), times the potential drop
    over the step length, clipped at 0, centre 0; rows that touch the
    grid edge take the directional prior."""
    w = np.clip(np.asarray(cond, np.float64), 1e-6, None)
    p = np.asarray(potential, np.float64)
    nrow, ncol = w.shape
    wpad = np.pad(w, 1, constant_values=1e-6)
    ppad = np.pad(p, 1, constant_values=np.nan)
    out = np.empty((nrow, ncol, 9))
    for m, (dr, dc) in enumerate(DELTAS):
        wn = wpad[1 + dr:1 + dr + nrow, 1 + dc:1 + dc + ncol]
        pn = ppad[1 + dr:1 + dr + nrow, 1 + dc:1 + dc + ncol]
        out[..., m] = 2. / (1. / w + 1. / wn) * (p - pn) * INV_STEP[m]
    with np.errstate(invalid='ignore'):
        out = np.clip(out, 0., None) * NOT_CENTRE
    edge = np.isnan(out).any(axis=-1, keepdims=True)
    out = np.where(edge, prior * NOT_CENTRE, out)
    return out.reshape(-1, 9)


def starting_cells(ntracks, sbounds, width_km, res, rng):
    """Uniform random start cells in the km-bounded start window, with
    the reference's index clamping; returns (rows, cols)."""
    res_km = res / 1000.
    xmax = ceil(width_km[0] / res_km)
    ymax = ceil(width_km[1] / res_km)
    x0 = min(max(floor(sbounds[0] / res_km) - 1, 1), xmax - 2)
    x1 = max(min(ceil(sbounds[1] / res_km), xmax - 1), 2)
    y0 = min(max(floor(sbounds[2] / res_km) - 1, 1), ymax - 2)
    y1 = max(min(ceil(sbounds[3] / res_km), ymax - 1), 2)
    xs, ys = np.mgrid[x0:x1, y0:y1]
    cells = np.vstack((ys.ravel(), xs.ravel()))
    pick = rng.integers(0, cells.shape[1], ntracks)
    return cells[0, pick], cells[1, pick]


def walk_tracks(cond, potential, move_dirn, starts, nsteps, rng):
    """The stochastic directed walk of ``starts`` (N, 2) agents over the
    float64 weights, all agents advanced together with NumPy. Each step:
    agents push off the edge during burn-in (the first min(nrow, ncol)/10
    steps) and die on it after; the 3x3 weights of the agent's cell are
    masked by the previous move, fall back to the masked prior and then
    the prior when all zero, and one move is drawn by inverse CDF.
    Returns the int64 visit counts (start included) and the number of
    moves made."""
    table = weight_table(cond, potential, directional_prior(move_dirn))
    prior = directional_prior(move_dirn)
    masks = restriction_masks()
    nrow, ncol = np.shape(cond)
    burnin = int(min(nrow, ncol) / 10)
    r = np.asarray(starts[:, 0], np.int64).copy()
    c = np.asarray(starts[:, 1], np.int64).copy()
    last = np.full(r.size, 4)
    counts = np.bincount(r * ncol + c, minlength=nrow * ncol)
    moves = 0
    for step in range(nsteps):
        if step > burnin:
            inside = (r > 0) & (r < nrow - 1) & (c > 0) & (c < ncol - 1)
            r, c, last = r[inside], c[inside], last[inside]
            if r.size == 0:
                break
        else:
            r = np.where(r <= 1, r + 2, np.where(r >= nrow - 2, r - 2, r))
            c = np.where(c <= 0, c + 2, np.where(c >= ncol - 2, c - 2, c))
        mask = masks[last]
        p = table[r * ncol + c] * mask
        dead = p.sum(axis=1) == 0
        p[dead] = (prior * NOT_CENTRE)[None] * mask[dead]
        dead = p.sum(axis=1) == 0
        p[dead] = prior
        cdf = np.cumsum(p, axis=1)
        u = rng.random(r.size) * cdf[:, -1]
        m = np.minimum((cdf < u[:, None]).sum(axis=1), 8)
        r = r + DELTAS[m, 0]
        c = c + DELTAS[m, 1]
        last = m
        moves += r.size
        counts += np.bincount(r * ncol + c, minlength=nrow * ncol)
    return counts.reshape(nrow, ncol), moves


# ---- presence maps --------------------------------------------------------

def circular_kernel(krad):
    """Flat disc of radius ``krad`` cells, normalized to sum 1."""
    y, x = np.ogrid[-krad:krad + 1, -krad:krad + 1]
    k = (x ** 2 + y ** 2 <= krad ** 2).astype(np.float64)
    return k / k.sum()


def smooth(counts, krad, lower=False):
    """'same'-size 2-D convolution with the circular kernel."""
    counts = np.asarray(counts, np.float64)
    k = circular_kernel(krad)
    if lower:
        return _bf16(scipy.signal.fftconvolve(_bf16(counts), _bf16(k),
                                              mode='same'))
    return scipy.signal.fftconvolve(counts, k, mode='same')


def summary_presence(case_counts, krad, lower=False):
    """Sum over cases of each case's max-normalized smoothed presence,
    max-normalized."""
    total = 0.
    for counts in case_counts:
        s = smooth(counts, krad, lower)
        total = total + s / s.max()
    return total / np.max(total)
