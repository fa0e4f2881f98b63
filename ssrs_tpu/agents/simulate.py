"""The agent simulation core: all tracks advance in lockstep.

The reference simulates each track with a sequential Python while-loop in a
process pool, one agent per task (ssrs/movmodel.py:264-318,
ssrs/simulator.py:360-381). Here the same stochastic process is a
``lax.scan`` over steps with the whole agent population batched per step:

- per-cell move weights (harmonic-mean updraft lift x potential drop x
  inverse distance, ssrs/movmodel.py:294-305) depend only on the cell, so
  they are precomputed once into a ``(nrow, ncol, 9)`` table and each
  agent-step is a 9-float gather;
- the direction-memory restriction is a ring buffer of the last K move
  indices, AND-ing rows of a static (9, 9) mask table
  (ssrs/movmodel.py:307-309);
- the fallback cascade and nu-sharpening follow
  ``generate_move_probabilities`` (ssrs/movmodel.py:220-244);
- moves are sampled by inverse-CDF with one uniform per agent-step
  (statistically equivalent to ``np.random.choice``, ssrs/movmodel.py:312);
- burn-in boundary pushes and boundary absorption are masks
  (ssrs/movmodel.py:276,285-291,205-217);
- presence maps accumulate on device per step, so 100k x 10k trajectories
  never materialize.

Presence accumulation is DELAYED BY ONE STEP in every engine: step t
counts the *carried* position with the previous step's alive mask
(``palive``), and the driver adds the final pending positions once at the
end (and at compaction boundaries). The counted multiset of (position,
alive) pairs is identical to counting each step's new position
immediately — but it removes the sample->histogram data dependency inside
the step, so the histogram of step t and the gather/cascade of step t+1
have no ordering constraint between them.

The step is plain XLA (``TrackParams.step_impl`` accepts ``'auto'`` and
``'xla'``, both meaning this step); presence is a scatter-add or a
one-hot int8 matmul histogram (``TrackParams.presence_impl``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .moves import (CENTER_ZERO, NEIGHBOR_DELTAS, NEIGHBOR_NORMS_INV,
                    directional_probs, restriction_table)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class TrackParams(NamedTuple):
    """Static per-run parameters of the movement model."""
    grid_shape: Tuple[int, int]        # (nrow, ncol)
    move_dirn: float                   # degrees cw from north
    nu: float                          # sharpening exponent
    memory_k: int                      # direction-memory length (>= 0)
    burnin: int                        # boundary-push steps
    nsteps: int                        # step cap (static)
    # storage dtype of the per-cell move-weight table: 'auto' (default,
    # resolve_weight_dtype) and 'float32' keep the reference's working
    # precision; 'bfloat16' (~0.4% relative weight quantization that the
    # presence statistics absorb, verified in tests) halves the bytes
    # each agent-step gathers.
    weight_dtype: str = 'auto'
    # presence accumulation: 'auto' (resolve_presence_impl), 'scatter'
    # (scatter-add of the agents' cells), 'matmul' (one-hot int8 matmul
    # histogram; exact, bit-identical to the scatter), or 'none' (no
    # presence in the step; the caller accumulates).
    presence_impl: str = 'auto'
    # step engine: 'auto' | 'xla', both the plain XLA step.
    step_impl: str = 'auto'

    @property
    def padded_grid(self) -> Tuple[int, int]:
        return (_round_up(self.grid_shape[0], 8),
                _round_up(self.grid_shape[1], 128))


def resolve_presence_impl(presence_impl: str) -> str:
    """Resolve presence 'auto' to the scatter-add.

    The one-hot matmul costs N * nrow_p * ncol_p multiply-adds per step
    and writes two N-row one-hot operands, while the scatter is N int32
    atomic adds; on the GPU the scatter was faster at every grid area
    timed (PERF.md, bring-up measurements), so 'auto' does not depend
    on the grid. 'matmul' stays selectable and is bit-identical."""
    return 'scatter' if presence_impl == 'auto' else presence_impl


def resolve_step_impl(params: TrackParams) -> str:
    """Validate ``step_impl``; every accepted value is the XLA step."""
    impl = params.step_impl
    if impl in ('fused', 'fused-interpret'):
        raise ValueError(
            f"step_impl={impl!r}: the fused TPU step kernel was "
            "removed; use 'auto' or 'xla' (the XLA step)")
    if impl not in ('auto', 'xla'):
        raise ValueError(
            f"step_impl={impl!r}: expected 'auto' or 'xla'")
    return 'xla'


def harmonic_mean_weights(updraft: jax.Array,
                          potential: Optional[jax.Array]) -> jax.Array:
    """Precompute per-cell move weights ``(nrow, ncol, 9)``.

    base[r, c, m] = hm(w[r, c], w[r+dr, c+dc])
                    * [(p[r, c] - p[r+dr, c+dc]) / ||d||  if potential given]

    matching the 3x3 patch math at ssrs/movmodel.py:294-305 (updraft clipped
    to >= 1e-6 first, center weight 0 via the zero potential drop /
    zero inverse norm). Border rows/cols are never gathered as centers
    (agents are pushed or absorbed first) and hold zeros.
    """
    w = jnp.clip(jnp.asarray(updraft, jnp.float32), min=1e-6)
    wpad = jnp.pad(w, 1, mode='constant', constant_values=1e-6)
    layers = []
    inv_norms = NEIGHBOR_NORMS_INV
    if potential is not None:
        p = jnp.asarray(potential, jnp.float32)
        ppad = jnp.pad(p, 1, mode='constant', constant_values=jnp.nan)
    nrow, ncol = w.shape
    for m in range(9):
        dr, dc = int(NEIGHBOR_DELTAS[m, 0]), int(NEIGHBOR_DELTAS[m, 1])
        wn = jax.lax.dynamic_slice(wpad, (dr + 1, dc + 1), (nrow, ncol))
        hm = 2.0 / (1.0 / w + 1.0 / wn)
        if potential is not None:
            pn = jax.lax.dynamic_slice(ppad, (dr + 1, dc + 1), (nrow, ncol))
            hm = hm * (p - pn) * inv_norms[m]
        elif m == 4:
            hm = jnp.zeros_like(hm)
        layers.append(hm)
    return jnp.stack(layers, axis=-1)


def resolve_weight_dtype(dtype: str) -> str:
    """Resolve the 'auto' weight-storage tier to float32, the
    reference's working precision.

    Each agent-step gathers one 36 B (f32) or 18 B (bf16) table row; on
    the GPU a bf16 table did not make the step faster at any grid timed
    (PERF.md, bring-up measurements), so 'auto' does not depend on the
    grid. Explicit 'float32'/'bfloat16' pass through."""
    return 'float32' if dtype == 'auto' else dtype


def _prepared_weights_body(updraft, potential, dirp, dtype):
    base = harmonic_mean_weights(updraft, potential)
    center0 = jnp.asarray(CENTER_ZERO)
    base = jnp.clip(base, min=0.) * center0
    row_nan = jnp.any(jnp.isnan(base), axis=-1, keepdims=True)
    base = jnp.where(row_nan, dirp * center0, base)
    return base.reshape(-1, 9).astype(dtype)


@functools.partial(jax.jit, static_argnames=('dtype',))
def prepared_weights(updraft: jax.Array, potential: Optional[jax.Array],
                     dirp: jax.Array, dtype) -> jax.Array:
    """Move-weight table with the per-agent cascade prologue folded in.

    The first three operations of ``generate_move_probabilities``
    (ssrs/movmodel.py:227-232) — replace-with-directional-prior on NaN,
    clip to >= 0, zero the center — depend only on the cell, so they are
    applied once here instead of at every agent-step. Returns the
    flattened (nrow*ncol, 9) table in the requested storage dtype
    (``'auto'`` resolves via :func:`resolve_weight_dtype`).

    Jitted as ONE dispatch: eagerly, each of its ~60 elementwise ops
    would be a separate dispatch.
    """
    dtype = resolve_weight_dtype(dtype)
    return _prepared_weights_body(updraft, potential, dirp, dtype)


@functools.partial(jax.jit, static_argnames=('dtype',))
def prepared_weights_batch(updrafts: jax.Array, potentials: jax.Array,
                           dirps: jax.Array, dtype) -> jax.Array:
    """All C cases' weight tables in ONE dispatch: (C, nrow, ncol)
    updrafts/potentials + (C, 9) priors -> (C, nrow*ncol, 9) tables.

    The multi-case prep pattern: one vmapped program instead of C
    :func:`prepared_weights` dispatches.
    """
    dtype = resolve_weight_dtype(dtype)
    return jax.vmap(
        lambda u, p, d: _prepared_weights_body(u, p, d, dtype))(
            updrafts, potentials, dirps)


def _push_from_boundary(r: jax.Array, c: jax.Array, nrow: int, ncol: int):
    """Burn-in boundary push (ssrs/movmodel.py:205-217). Note the
    reference's asymmetry: rows pushed when <= 1, cols when <= 0."""
    r = jnp.where(r <= 1, r + 2, jnp.where(r >= nrow - 2, r - 2, r))
    c = jnp.where(c <= 0, c + 2, jnp.where(c >= ncol - 2, c - 2, c))
    return r, c


class SimState(NamedTuple):
    pos_r: jax.Array      # (N,) int32 current row
    pos_c: jax.Array      # (N,) int32 current col
    mem: jax.Array        # (K, N) int32 move-index ring buffer (init 4),
    #                       oldest move first (row 0)
    alive: jax.Array      # (N,) bool
    palive: jax.Array     # (N,) int32: previous step's alive mask — the
    #                       weight of the carried position in the pending
    #                       (delayed) presence update
    key: jax.Array        # scalar PRNG key
    presence: jax.Array   # (nrow_p, ncol_p) int32, tile-padded
    step: jax.Array       # scalar int32

    @property
    def pos(self) -> jax.Array:
        """(N, 2) int32 view for trajectory emission."""
        return jnp.stack([self.pos_r, self.pos_c], axis=1)


def _hist_padded(r, c, weight_i32, nrow_p: int, ncol_p: int,
                 use_matmul: bool) -> jax.Array:
    """(nrow_p, ncol_p) int32 histogram of (r, c) with int32 weights."""
    if use_matmul:
        oh_r = jnp.where(weight_i32[:, None] != 0,
                         (r[:, None] == jax.lax.broadcasted_iota(
                             jnp.int32, (1, nrow_p), 1)).astype(jnp.int8),
                         jnp.int8(0))
        oh_c = (c[:, None] == jax.lax.broadcasted_iota(
            jnp.int32, (1, ncol_p), 1)).astype(jnp.int8)
        # int8 x int8 -> int32: integer arithmetic, exact, no TF32
        return jax.lax.dot_general(
            oh_r, oh_c, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
    flat = r * ncol_p + c
    return jnp.zeros((nrow_p * ncol_p,), jnp.int32).at[flat].add(
        weight_i32, mode='promise_in_bounds').reshape(nrow_p, ncol_p)


def flush_pending(params: TrackParams, state: SimState) -> SimState:
    """Add the pending delayed-presence contribution (the carried
    positions weighted by ``palive``) and zero ``palive`` so subsequent
    steps cannot double-count. Call at the end of a run and before any
    compaction/reordering of the agent axis.

    With ``presence_impl='none'`` the step accumulates nothing, so the
    flush only clears ``palive`` (presence stays zero / caller-owned)."""
    nrow_p, ncol_p = params.padded_grid
    impl = params.presence_impl
    if impl == 'none':
        return state._replace(palive=jnp.zeros_like(state.palive))
    upd = _hist_padded(state.pos_r, state.pos_c, state.palive,
                       nrow_p, ncol_p,
                       resolve_presence_impl(impl) == 'matmul')
    return state._replace(presence=state.presence + upd,
                          palive=jnp.zeros_like(state.palive))


def make_step_fn(params: TrackParams, base_flat: Optional[jax.Array],
                 dirp: jax.Array, table: jax.Array):
    """Build the per-step transition function.

    ``base_flat`` is the flattened ``(nrow*ncol, 9)`` per-cell weight
    table produced by ``prepared_weights`` (cascade prologue pre-applied;
    None for the pure directed-random-walk model,
    ssrs/simulator.py:370-381).

    The returned ``step(state, u=None)`` accepts optional per-agent
    uniforms in [0, 1); when None they are drawn from the carried key.
    Presence is accumulated with the one-step delay described in the
    module docstring — callers must :func:`flush_pending` at the end.
    """
    if params.presence_impl not in ('auto', 'matmul', 'scatter', 'none'):
        raise ValueError(
            f"presence_impl={params.presence_impl!r}: expected one of "
            "'auto', 'matmul', 'scatter', 'none'")
    resolve_step_impl(params)
    return _make_xla_step(params, base_flat, dirp, table)


def _alive_and_push(params: TrackParams, state: SimState):
    nrow, ncol = params.grid_shape
    r, c = state.pos_r, state.pos_c
    in_interior = (r > 0) & (r < nrow - 1) & (c > 0) & (c < ncol - 1)
    past_burnin = state.step > params.burnin
    under_cap = state.step < params.nsteps  # chunked loop may overshoot
    alive = state.alive & (in_interior | ~past_burnin) & under_cap
    pr, pc = jax.lax.cond(
        past_burnin,
        lambda rc: rc,
        lambda rc: _push_from_boundary(rc[0], rc[1], nrow, ncol),
        (r, c))
    return alive, pr, pc


def _make_xla_step(params: TrackParams, base_flat: Optional[jax.Array],
                   dirp: jax.Array, table: jax.Array):
    nrow, ncol = params.grid_shape
    nrow_p, ncol_p = params.padded_grid
    deltas = jnp.asarray(NEIGHBOR_DELTAS)
    center0 = jnp.asarray(CENTER_ZERO)
    dirp_c0 = dirp * center0
    # All per-move math runs in (9, N) layout: the agent axis is minor
    # (contiguous), so every cascade/cumsum/compare op streams over
    # agents; addition order per agent is the same as in an (N, 9)
    # layout, so sampling is bit-identical for the same uniforms.
    table_T = table.T                       # (9, 9)
    dirp_T = dirp[:, None]                  # (9, 1)
    dirp_c0_T = dirp_c0[:, None]
    center0_T = center0[:, None]
    dr_tab, dc_tab = deltas[:, 0], deltas[:, 1]

    def step(state: SimState, u: Optional[jax.Array] = None) -> SimState:
        r, c = state.pos_r, state.pos_c
        alive, pr, pc = _alive_and_push(params, state)

        if params.memory_k > 0:
            # one-hot 9x9 matmul instead of jnp.take of the (9, 9)
            # table at N indices. TF32 cannot change it: both operands
            # are 0/1, exact in TF32, and each output sums at most one
            # nonzero product, so no precision argument is needed
            def _mask_for(row):
                ohm = (row[None, :] == jax.lax.broadcasted_iota(
                    jnp.int32, (9, 1), 0)).astype(jnp.float32)
                return jax.lax.dot_general(
                    table_T.astype(jnp.float32), ohm,
                    (((1,), (0,)), ((), ())))

            mask = center0_T * _mask_for(state.mem[0])
            for k in range(1, params.memory_k):
                mask = mask * _mask_for(state.mem[k])
        else:
            mask = None

        if base_flat is not None:
            idx = pr * ncol + pc
            base = base_flat.at[idx].get(
                mode='promise_in_bounds').T.astype(jnp.float32)  # (9, N)
        else:
            base = jnp.broadcast_to(dirp_c0_T, (9, r.shape[0]))

        # fallback cascade (ssrs/movmodel.py:233-241); the NaN/clip/center
        # prologue is folded into the table by prepared_weights
        p = base * mask if mask is not None else base
        if mask is not None:
            allz = jnp.sum(p, axis=0, keepdims=True) == 0.
            p = jnp.where(allz, dirp_c0_T * mask, p)
        allz = jnp.sum(p, axis=0, keepdims=True) == 0.
        p = jnp.where(allz, dirp_T, p)
        if params.nu != 1.0:
            # normalize by the row max before sharpening: proportionality
            # is preserved and the raw weights (up to ~1e4) can neither
            # overflow f32 for large nu nor underflow the whole row to an
            # all-zero cumsum (the reference powers an already-normalized
            # probability vector, ssrs/movmodel.py:242-243)
            p = p / jnp.max(p, axis=0, keepdims=True)
            p = jnp.power(p, params.nu)

        key = state.key
        if u is None:
            key, sub = jax.random.split(key)
            u = jax.random.uniform(sub, (p.shape[1],), dtype=p.dtype)
        # force u > 0 so a zero-probability move (zero-width CDF interval
        # at index 0) is unreachable, matching np.random.choice which never
        # selects zero-probability entries (ssrs/movmodel.py:312)
        u = jnp.maximum(u, jnp.finfo(p.dtype).tiny)
        cum = jnp.cumsum(p, axis=0)
        mi = jnp.sum(cum < u[None, :] * cum[-1:, :],
                     axis=0).astype(jnp.int32)
        mi = jnp.minimum(mi, 8)

        new_r = jnp.where(alive, pr + jnp.take(dr_tab, mi), r)
        new_c = jnp.where(alive, pc + jnp.take(dc_tab, mi), c)

        if params.memory_k > 0:
            new_mem = jnp.concatenate(
                [state.mem[1:], mi[None]], axis=0)
            new_mem = jnp.where(alive[None], new_mem, state.mem)
        else:
            new_mem = state.mem

        impl = resolve_presence_impl(params.presence_impl)
        if impl == 'none':
            presence = state.presence
        else:
            # delayed histogram of the CARRIED position (see module
            # docstring); the driver flushes the final pending update
            upd = _hist_padded(r, c, state.palive, nrow_p, ncol_p,
                               use_matmul=(impl == 'matmul'))
            presence = state.presence + upd

        # the counter saturates at the cap: chunked drivers run whole
        # chunks, so a free-running counter overshot by up to chunk-1
        # in every reported steps_taken value
        return SimState(pos_r=new_r, pos_c=new_c, mem=new_mem,
                        alive=alive, palive=alive.astype(jnp.int32),
                        key=key, presence=presence,
                        step=jnp.minimum(state.step + 1, params.nsteps))

    return step


@functools.partial(jax.jit, static_argnames=('params',))
def init_state(params: TrackParams, start_rc: jax.Array,
               key: jax.Array,
               valid: Optional[jax.Array] = None) -> SimState:
    """Initial state (one jitted dispatch — see prepared_weights on why).
    The start cell counts toward presence (the reference
    trajectory includes the start, ssrs/movmodel.py:281-283) — it is the
    first pending delayed update (``palive = valid``), added by the first
    step or the final flush.

    ``valid`` marks real agents; padding agents (added to make the batch
    divisible across devices) start dead and contribute nothing.
    """
    nrow_p, ncol_p = params.padded_grid
    pos = jnp.asarray(start_rc, jnp.int32)
    n = pos.shape[0]
    pos_r, pos_c = pos[:, 0], pos[:, 1]
    # derive from pos so the varying-axis type matches under shard_map
    # (a fresh jnp.full would be unvarying and break the scan carry)
    mem = jnp.broadcast_to((pos_r * 0 + 4)[None],
                           (max(params.memory_k, 1), n)).astype(jnp.int32)
    alive = (pos_r == pos_r) if valid is None \
        else jnp.asarray(valid, bool)
    # also derived from pos (varying under shard_map); fresh zeros would
    # be unvarying and mismatch the step's output in the scan carry
    presence = jnp.zeros((nrow_p, ncol_p), jnp.int32) + pos_r[0] * 0
    return SimState(pos_r=pos_r, pos_c=pos_c, mem=mem, alive=alive,
                    palive=alive.astype(jnp.int32), key=key,
                    presence=presence, step=jnp.asarray(0, jnp.int32))


def _as_starts(start_rc):
    """Device arrays pass through untouched; lists / tuples of (row,
    col) pairs and host arrays become an int32 host array."""
    if isinstance(start_rc, jax.Array):
        return start_rc
    return np.asarray(start_rc, np.int32)


def prepare_starts(start_rc, valid=None):
    """Device-put a start batch ONCE for reuse across cases.

    A multi-case sweep (8 wind directions, seasonal snapshots, bench
    repetitions) reuses the same starts; the returned device-resident
    (starts, valid) pair is passed to every case instead of uploading
    the host array per case.
    """
    starts_d = jax.device_put(jnp.asarray(_as_starts(start_rc), jnp.int32))
    valid_d = None if valid is None \
        else jax.device_put(jnp.asarray(valid, bool))
    return starts_d, valid_d


def _presence_out(params: TrackParams, presence: jax.Array) -> jax.Array:
    nrow, ncol = params.grid_shape
    return presence[:nrow, :ncol]


@functools.partial(jax.jit, static_argnames=('params', 'record_tracks',
                                             'chunk'))
def simulate_presence(params: TrackParams, start_rc: jax.Array,
                      key: jax.Array,
                      updraft: Optional[jax.Array] = None,
                      potential: Optional[jax.Array] = None,
                      record_tracks: bool = False,
                      chunk: int = 128,
                      valid: Optional[jax.Array] = None):
    """Simulate all tracks and return the presence-count map.

    Without ``record_tracks``: runs a while-loop over chunks of ``chunk``
    scan steps with an all-dead early exit (the reference stops each track
    at boundary exit; most die long before the cap). Returns
    ``(presence int32 (nrow, ncol), steps_taken int32)``.

    With ``record_tracks``: additionally materializes the (nsteps+1, N, 2)
    int16 trajectory array (small runs only — memory is nsteps*N*4 bytes).
    """
    dirp = jnp.asarray(directional_probs(params.move_dirn))
    table = jnp.asarray(restriction_table())
    if updraft is not None:
        base_flat = prepared_weights(updraft, potential, dirp,
                                     params.weight_dtype)
    else:
        base_flat = None
    start_rc = jnp.asarray(start_rc)
    step_fn = make_step_fn(params, base_flat, dirp, table)
    state = init_state(params, start_rc, key, valid=valid)

    if record_tracks:
        def scan_body(st, _):
            new = step_fn(st)
            return new, (new.pos.astype(jnp.int16), new.alive)
        state, (track_tail, alive_tail) = jax.lax.scan(
            scan_body, state, None, length=params.nsteps)
        state = flush_pending(params, state)
        tracks = jnp.concatenate(
            [jnp.asarray(start_rc, jnp.int16)[None], track_tail], axis=0)
        # per-agent trajectory length = 1 (start) + moves made
        lengths = 1 + jnp.sum(alive_tail.astype(jnp.int32), axis=0)
        return (_presence_out(params, state.presence), state.step,
                tracks, lengths)

    nchunks = -(-params.nsteps // chunk)

    def chunk_body(st, _):
        return step_fn(st), None

    def while_cond(carry):
        st, i = carry
        return (i < nchunks) & jnp.any(st.alive)

    def while_body(carry):
        st, i = carry
        st, _ = jax.lax.scan(chunk_body, st, None, length=chunk)
        return st, i + 1

    state, _ = jax.lax.while_loop(
        while_cond, while_body, (state, jnp.asarray(0, jnp.int32)))
    state = flush_pending(params, state)
    return _presence_out(params, state.presence), state.step


_CHUNK_UNROLL = 4


@functools.partial(jax.jit, static_argnames=('params', 'chunk'))
def _run_chunk(params: TrackParams, base_flat, dirp, table, state,
               chunk: int):
    """One jitted chunk of the compacting driver; compiled once per
    (params, agent-bucket-size). Uniforms are drawn per step inside the
    scan, so no (chunk, N) buffer of them is written to memory."""
    step_fn = make_step_fn(params, base_flat, dirp, table)
    state, _ = jax.lax.scan(lambda s, _: (step_fn(s), None), state, None,
                            length=chunk, unroll=_CHUNK_UNROLL)
    return state, jnp.sum(state.alive)


@functools.partial(jax.jit, static_argnames=('params', 'chunk'))
def _run_tail(params: TrackParams, base_flat, dirp, table, state,
              chunk: int):
    """Run the REMAINDER of a simulation in one dispatch: a device-side
    while_loop of chunk-scans with an all-dead early exit.

    Used by the compacting driver once the bucket has shrunk to
    min_bucket, where no further compaction is possible: one dispatch
    for the whole tail replaces one host round trip per chunk."""
    step_fn = make_step_fn(params, base_flat, dirp, table)

    def cond(st):
        return (st.step < params.nsteps) & jnp.any(st.alive)

    def body(st):
        st, _ = jax.lax.scan(lambda s, _: (step_fn(s), None), st, None,
                             length=chunk, unroll=_CHUNK_UNROLL)
        return st

    state = jax.lax.while_loop(cond, body, state)
    state = flush_pending(params, state)
    return state, jnp.sum(state.alive)


_DISPATCH_OVERHEAD = None
# auto tail-switch per-slot device-cost estimates, keyed (params, chunk)
_PER_SLOT: dict = {}


@functools.partial(jax.jit, static_argnames=('params',))
def _prologue_jit(params: TrackParams, updraft, potential, dirp,
                  starts_p, key, valid):
    """Weight table + initial state in ONE dispatch."""
    base_flat = prepared_weights(updraft, potential, dirp,
                                 params.weight_dtype)
    state = init_state(params, starts_p, key, valid=valid)
    return base_flat, state


def _dispatch_overhead() -> float:
    """One measured host->device dispatch + device->host scalar read
    round trip (seconds), cached per process — the live input to the
    compacting driver's auto tail-switch rule."""
    global _DISPATCH_OVERHEAD
    if _DISPATCH_OVERHEAD is None:
        import time as _time
        f = jax.jit(lambda x: x + 1)
        x = jnp.zeros((), jnp.int32)
        int(f(x))  # compile + device-put outside the timed trip
        t0 = _time.perf_counter()
        int(f(x))
        t1 = _time.perf_counter()
        int(f(x))
        _DISPATCH_OVERHEAD = min(t1 - t0, _time.perf_counter() - t1)
    return _DISPATCH_OVERHEAD


def _bucket_for(n_alive: int, min_bucket: int) -> int:
    """Smallest {1, 1.5} * 2^k >= n_alive (>= min_bucket).

    A pure power-of-two ladder leaves up to 2x dead slots before the
    first compaction triggers (measured on the bench workload: the
    second 1024-step chunk ran a 100k bucket while alive fell 64k ->
    8.6k); the 1.5x intermediate rungs cut that to 1.5x for at most 2x
    the compile-cache entries (_run_chunk is compiled per bucket size,
    all cached persistently)."""
    n = max(n_alive, min_bucket, 1)
    p = 1 << max(n.bit_length() - 1, 0)      # largest pow2 <= n
    if p >= n:
        m = p
    elif 3 * p // 2 >= n:
        m = 3 * p // 2
    else:
        m = 2 * p
    return m


def _norm_tail_bucket(tail_bucket, min_bucket: int) -> int:
    """Normalize the ``tail_bucket`` knob shared by every compacting
    driver (Config.track_tail_bucket is typed ``object`` and can arrive
    from a run JSON): 0 or 'auto' -> switch at ``min_bucket``, negative
    int -> never switch (-1), positive int -> that bucket floored at
    ``min_bucket``. Anything else raises a clear ValueError instead of
    an unrelated TypeError deep in a comparison."""
    if tail_bucket == 'auto':
        return min_bucket
    if isinstance(tail_bucket, (int, np.integer)) \
            and not isinstance(tail_bucket, bool):
        tb = int(tail_bucket)
        if tb == 0:
            return min_bucket
        return -1 if tb < 0 else max(min_bucket, tb)
    raise ValueError(
        "tail_bucket must be 'auto', 0 (switch at min_bucket), a "
        'negative int (never switch), or a positive int bucket; got '
        f'{tail_bucket!r}')


def _compact_body(params: TrackParams, state: SimState, m: int):
    """Shared compaction body: flush, stable-pack alive agents to the
    front, truncate to bucket m. Returns (state, order) so the
    track-recording driver can reorder its ids with the same permutation
    — ONE definition keeps the presence and recording drivers'
    compaction semantics from drifting."""
    state = flush_pending(params, state)
    order = jnp.argsort(~state.alive, stable=True)[:m]
    return state._replace(pos_r=state.pos_r[order],
                          pos_c=state.pos_c[order],
                          mem=state.mem[:, order],
                          alive=state.alive[order],
                          palive=state.palive[order]), order


@functools.partial(jax.jit, static_argnames=('params', 'm'))
def _compact(params: TrackParams, state: SimState, m: int) -> SimState:
    """Pack alive agents to the front (stable) and truncate to bucket m.
    The pending delayed-presence update is flushed first — compaction
    reorders/drops agent slots, which would corrupt it."""
    return _compact_body(params, state, m)[0]


@functools.partial(jax.jit, static_argnames=('params', 'm'))
def _compact_ids(params: TrackParams, state: SimState, ids, m: int):
    state, order = _compact_body(params, state, m)
    return state, ids[order]


@functools.partial(jax.jit, static_argnames=('params',))
def _final_flush(params: TrackParams, state: SimState):
    state = flush_pending(params, state)
    return _presence_out(params, state.presence), state.step


@functools.partial(jax.jit, static_argnames=('params', 'chunk'))
def _run_chunk_recording(params: TrackParams, base_flat, dirp, table,
                         state, chunk: int):
    """Chunk runner that also emits per-step (positions, alive) for track
    reconstruction."""
    step_fn = make_step_fn(params, base_flat, dirp, table)

    def body(s, _):
        new = step_fn(s)
        return new, (new.pos.astype(jnp.int16), new.alive)

    state, ys = jax.lax.scan(body, state, None, length=chunk)
    return state, jnp.sum(state.alive), ys


def simulate_tracks_recorded(params: TrackParams, start_rc,
                             key: jax.Array,
                             updraft=None, potential=None,
                             chunk: int = 512,
                             min_bucket: int = 1024):
    """Full-trajectory simulation with early exit and compaction.

    Returns (presence int32 (nrow, ncol), list of int16 (len, 2)
    trajectories in reference format, ssrs/movmodel.py:318). Each agent's
    trajectory is reconstructed host-side from per-chunk emissions, so the
    step cap can be the reference's enormous ``(nrow/2)*(ncol/2)`` without
    materializing a dense (cap, N, 2) array.
    """
    dirp = jnp.asarray(directional_probs(params.move_dirn))
    table = jnp.asarray(restriction_table())
    if updraft is not None:
        base_flat = prepared_weights(updraft, potential, dirp,
                                     params.weight_dtype)
    else:
        base_flat = None

    start_rc = np.asarray(start_rc, np.int32)
    n = start_rc.shape[0]
    state = init_state(params, start_rc, key)
    ids = jnp.arange(n, dtype=jnp.int32)

    # host-side per-agent trajectory buffers, seeded with the starts:
    # the C++ builder (ssrs_tpu/native) when a compiler is around,
    # the pure-Python list-append loop otherwise (same semantics,
    # asserted equal in tests/test_agents.py::test_native_trackbuilder)
    from ..native import TrackBuilder, native_available
    builder = TrackBuilder(start_rc.astype(np.int16)) \
        if native_available() else None
    if builder is None:
        traj = [[start_rc[i:i + 1]] for i in range(n)]
    # host step counter + optimistic initial alive count: see the sync
    # discipline note in simulate_presence_compacting
    steps_done = 0
    n_alive = state.pos_r.shape[0]
    while steps_done < params.nsteps and n_alive > 0:
        steps_done += chunk
        state, _, (ys_pos, ys_alive) = _run_chunk_recording(
            params, base_flat, dirp, table, state, chunk)
        ys_pos = np.asarray(ys_pos)          # (chunk, B, 2)
        ys_alive = np.asarray(ys_alive)      # (chunk, B)
        # post-chunk alive count comes free with the pulled emissions
        # (rows are post-step alive masks), saving a scalar sync
        n_alive = int(ys_alive[-1].sum())
        ids_h = np.asarray(ids)
        if builder is not None:
            builder.append_chunk(ys_pos, ys_alive, ids_h)
        else:
            for j, agent in enumerate(ids_h):
                steps_alive = int(ys_alive[:, j].sum())
                if steps_alive:
                    traj[agent].append(ys_pos[:steps_alive, j])
        cur = state.pos_r.shape[0]
        if n_alive > 0 and cur > min_bucket:
            m = _bucket_for(n_alive, min_bucket)
            if m < cur:
                state, ids = _compact_ids(params, state, ids, m)
    presence, _ = _final_flush(params, state)
    if builder is not None:
        return presence, builder.export()
    tracks = [np.ascontiguousarray(
        np.concatenate(parts, axis=0).astype(np.int16))
        for parts in traj]
    return presence, tracks


@functools.partial(jax.jit, static_argnames=('params', 'chunk'))
def simulate_presence_cases(params: TrackParams, base_tables: jax.Array,
                            dirps: jax.Array, start_rc: jax.Array,
                            keys: jax.Array, chunk: int = 128):
    """Batched multi-case simulation: C cases (e.g. a wind-direction or
    seasonal-snapshot sweep) advance together, vmapped over the case axis.

    The reference runs cases serially through its process pool
    (ssrs/simulator.py:348-386); here each case contributes an
    independent population and the whole (C, N)-agent batch runs as one
    program.

    Parameters
    ----------
    base_tables : (C, nrow*ncol, 9) prepared weight tables
    dirps : (C, 9) directional priors (may differ per case)
    start_rc : (N, 2) shared starts or (C, N, 2) per-case starts
    keys : (C,) PRNG keys

    Returns (presence int32 (C, nrow, ncol), steps int32 (C,)).
    """
    table = jnp.asarray(restriction_table())
    nchunks = -(-params.nsteps // chunk)

    def one_case(base_flat, dirp, starts, key):
        step_fn = make_step_fn(params, base_flat, dirp, table)
        state = init_state(params, starts, key)

        def while_cond(carry):
            st, i = carry
            return (i < nchunks) & jnp.any(st.alive)

        def while_body(carry):
            st, i = carry
            st, _ = jax.lax.scan(lambda s, _: (step_fn(s), None), st,
                                 None, length=chunk)
            return st, i + 1

        st, _ = jax.lax.while_loop(while_cond, while_body,
                                   (state, jnp.asarray(0, jnp.int32)))
        st = flush_pending(params, st)
        return _presence_out(params, st.presence), st.step

    start_axis = 0 if start_rc.ndim == 3 else None
    return jax.vmap(one_case, in_axes=(0, 0, start_axis, 0))(
        base_tables, dirps, start_rc, keys)


def simulate_presence_compacting(params: TrackParams, start_rc,
                                 key: jax.Array,
                                 updraft=None, potential=None,
                                 chunk: int = 512,
                                 min_bucket: int = 1024,
                                 valid=None,
                                 tail_bucket=0,
                                 base_flat=None,
                                 dirp=None):
    """Presence simulation with dead-agent compaction.

    ``base_flat``: an already-prepared ``(nrow*ncol, 9)`` weight table
    (``prepared_weights``); when given, ``updraft``/``potential`` are
    ignored and the table is used as-is — the multi-case driver
    (:func:`simulate_presence_cases_compacting`) prepares all case
    tables up front and passes them here. ``dirp`` optionally overrides
    the directional prior derived from ``params.move_dirn``.

    ``tail_bucket``: 0 (default) switches to the one-dispatch tail at
    min_bucket; a positive int switches at that bucket (floored at
    min_bucket — below it no compaction is possible, so an earlier
    switch cannot exist); negative never switches; ``'auto'``
    self-tunes the switch from measured dispatch cost (NOT
    deterministic run-to-run — see the policy note below).

    The plain lockstep scan keeps simulating dead agents: with boundary
    absorption the average track dies long before the step cap, so up to
    ~80% of agent-slots are wasted. This host-orchestrated variant runs
    jitted chunks and, whenever the live population falls below the
    current bucket, packs survivors into the next {1,1.5}*2^k bucket
    (at most ~2 log2(N) recompiles, each cached). Statistically
    equivalent to ``simulate_presence`` (different RNG partitioning), and
    deterministic for fixed inputs.

    Returns (presence int32 (nrow, ncol), steps int32).
    """
    if dirp is None:
        dirp = jnp.asarray(directional_probs(params.move_dirn))
    table = jnp.asarray(restriction_table())
    start_rc = _as_starts(start_rc)
    if base_flat is None and updraft is not None:
        base_flat, state = _prologue_jit(params, updraft, potential,
                                         dirp, start_rc, key, valid)
    else:
        state = init_state(params, start_rc, key, valid=valid)
    # Host-side sync discipline: every device->host scalar read waits
    # for the chunk's device work and leaves the device idle until the
    # next dispatch. The step counter needs no read
    # at all (init_state starts at 0 and every chunk advances exactly
    # `chunk`), and the initial alive count is taken optimistically as
    # the bucket size: if every start were dead the first chunk is a
    # semantic no-op (alive gating) and its count read ends the loop.
    # That leaves exactly ONE sync per chunk (the compaction decision)
    # and ZERO on the tail path.
    steps_done = 0
    n_alive = state.pos_r.shape[0]
    import os as _os
    import time as _time
    _dbg = _os.environ.get('SSRS_CHUNK_DEBUG')
    # Tail-switch policy. tail_bucket > 0: switch once the bucket is at
    # or below it; 0 (default): at min_bucket; negative: never
    # (testing); 'auto': switch as soon as one chunk's device work at
    # the new bucket costs less than the per-round host overhead, i.e.
    # m * chunk * per_slot < 2 * rtt. The measured scalar round trip
    # `rtt` is a LOWER bound on what each chunked round really pays
    # (the dispatch itself is not in it), so the factor 2 keeps the
    # rule from missing marginal cases while bounding the dead-slot
    # waste any uncompactable tail round can accrue at <= 2*rtt. Both
    # terms are measured live (rtt once per process, per_slot from
    # observed chunk walls); with sub-ms dispatch the rule degenerates
    # to the min_bucket switch.
    #
    # 'auto' is OPT-IN, not the default: the switch decision depends on
    # measured wall clocks, so the bucket trajectory — and with it the
    # RNG partitioning — can differ run-to-run near the decision
    # boundary, breaking this function's determinism contract. Leave it
    # off where bit-reproducibility from a seed matters (the Simulator
    # does); throughput-oriented drivers (bench.py, ensembles) opt in.
    auto_tail = tail_bucket == 'auto'
    tail_bucket = _norm_tail_bucket(tail_bucket, min_bucket)
    rtt = _dispatch_overhead() if auto_tail else 0.
    # per_slot persists across calls (min over all observed chunks for
    # this workload shape): a cold first call folds compile time into
    # its chunk walls and would never switch; warm repeat calls then
    # start with an honest estimate.
    ps_key = (params, chunk)
    per_slot = _PER_SLOT.get(ps_key) if auto_tail else None
    while steps_done < params.nsteps and n_alive > 0:
        _t0 = _time.perf_counter()
        cur = state.pos_r.shape[0]
        if tail_bucket > 0 and cur <= max(min_bucket, tail_bucket):
            # run the whole remainder in one dispatch (device-side early
            # exit; flushes internally)
            state, n_alive_dev = _run_tail(params, base_flat, dirp,
                                           table, state, chunk)
            if _dbg:
                print(f'[tail]  bucket={cur} alive={int(n_alive_dev)} '
                      f'steps={int(state.step)} '
                      f'dt={_time.perf_counter()-_t0:.3f}s', flush=True)
            return _presence_out(params, state.presence), state.step
        state, n_alive_dev = _run_chunk(params, base_flat, dirp, table,
                                        state, chunk)
        steps_done += chunk
        n_alive = int(n_alive_dev)
        wall = _time.perf_counter() - _t0
        if auto_tail and wall > rtt:
            # device-work estimate: chunk wall minus the round trip.
            # Samples with wall <= rtt are discarded — a chunk whose
            # wall undershoots a burst-inflated rtt would drive the
            # persisted min() toward zero and permanently force the
            # tail switch at any bucket for the whole process.
            est = (wall - rtt) / (cur * chunk)
            per_slot = est if per_slot is None else min(per_slot, est)
            _PER_SLOT[ps_key] = per_slot
        if _dbg:
            print(f'[chunk] bucket={state.pos_r.shape[0]} '
                  f'alive={n_alive} steps={int(state.step)} '
                  f'dt={wall:.3f}s', flush=True)
        if n_alive > 0 and cur > min_bucket:
            m = _bucket_for(n_alive, min_bucket)
            if m < cur:
                state = _compact(params, state, m)
                if (auto_tail and per_slot is not None
                        and m * chunk * per_slot < 2 * rtt):
                    tail_bucket = m  # switch on the next iteration
    return _final_flush(params, state)


def simulate_presence_cases_compacting(params: TrackParams, base_tables,
                                       start_rc, keys,
                                       dirps=None,
                                       chunk: int = 512,
                                       min_bucket: int = 1024,
                                       tail_bucket=0,
                                       valid=None,
                                       devices=None):
    """Multi-case presence simulation: the seasonal/sweep production
    path, with the single-case compacting driver's work savings
    available to every case.

    The jitted :func:`simulate_presence_cases` engine advances all C
    cases in lockstep under ``vmap`` and keeps every case's full agent
    bucket alive until the LAST case dies. This driver instead runs the
    cases through the host-orchestrated compacting pipeline —
    dead-agent compaction, one-dispatch tail, per-case early exit —
    ROUND-ROBIN INTERLEAVED: each round enqueues one chunk per
    still-active case before reading any case's alive count, so the
    scalar read of case i overlaps the device work of cases i+1..C (the
    device executes its queue in order; the host is the only thing that
    blocks). Per-round host cost stays ~1 round trip + C enqueues
    instead of C round trips.

    RNG: case i uses ``keys[i]`` exactly as the single-case compacting
    driver would — results per case are bit-identical to
    ``simulate_presence_compacting`` with the same key and bucket
    trajectory, and statistically equivalent to
    ``simulate_presence_cases`` (different RNG partitioning).

    Parameters
    ----------
    base_tables : (C, nrow*ncol, 9) stacked prepared tables, or a list
        of C ``(nrow*ncol, 9)`` tables (``prepared_weights`` output)
    start_rc : (N, 2) shared starts or (C, N, 2) per-case starts
    keys : (C,) PRNG keys (stacked or list)
    dirps : optional (C, 9) per-case directional priors; None derives
        the shared prior from ``params.move_dirn``
    tail_bucket : as in :func:`simulate_presence_compacting`; 'auto'
        here means "switch at min_bucket" — the interleaved rounds
        already overlap the round trip the auto rule exists to dodge, so
        the measured-cost rule adds nondeterminism for no win.
    devices : optional list of jax devices; case i runs on
        ``devices[i % len(devices)]`` — CASE parallelism, the
        device analog of the reference's one-process-per-case pool
        (ssrs/simulator.py:347,360-381) with ZERO collectives: each
        device advances its own cases, the host round-robin keeps every
        queue fed, and per-case results are bit-identical to the
        single-device driver (device placement does not change the
        math). Complements agent sharding
        (parallel.simulate_presence_sharded_compacting): shard agents
        when one population must span devices, spread cases when the
        sweep axis is the parallelism.

    Returns (presence int32 (C, nrow, ncol), steps int32 (C,)).
    """
    n_cases = len(base_tables)
    if devices:
        dev_for = [devices[i % len(devices)] for i in range(n_cases)]
        base_tables = [jax.device_put(base_tables[i], dev_for[i])
                       for i in range(n_cases)]
        keys = [jax.device_put(keys[i], dev_for[i])
                for i in range(n_cases)]
    else:
        dev_for = None
    table = jnp.asarray(restriction_table())
    # every array input of a jitted call must sit on the case's device
    table_list = [table] * n_cases if dev_for is None else \
        [jax.device_put(table, d) for d in dev_for]
    if dirps is None:
        shared_dirp = jnp.asarray(directional_probs(params.move_dirn))
        dirp_list = [shared_dirp] * n_cases
    else:
        dirp_list = [jnp.asarray(dirps[i]) for i in range(n_cases)]
    if dev_for is not None:
        dirp_list = [jax.device_put(dirp_list[i], dev_for[i])
                     for i in range(n_cases)]
    tail_switch = _norm_tail_bucket(tail_bucket, min_bucket)

    # Per-case starts arrive as a (C, N, 2) array OR a list/tuple of C
    # (N, 2) arrays (matching how base_tables/keys accept lists); shared
    # starts are a single (N, 2) array (or nested list of [r, c] pairs,
    # whose elements are 1-d — unambiguous).
    if isinstance(start_rc, (list, tuple)) \
            and all(np.ndim(s) == 2 for s in start_rc):
        if len(start_rc) != n_cases:
            raise ValueError(
                f'per-case start_rc list has {len(start_rc)} entries '
                f'for {n_cases} cases')
        per_case_starts = True
    else:
        # device-resident starts pass through untouched — np.asarray
        # here would copy them to the host just to re-upload them
        if not isinstance(start_rc, jax.Array):
            start_rc = np.asarray(start_rc)
        if start_rc.ndim not in (2, 3):
            raise ValueError(
                'start_rc must be (N, 2) shared starts or (C, N, 2) '
                f'per-case starts; got shape {start_rc.shape}')
        per_case_starts = start_rc.ndim == 3
        if per_case_starts and len(start_rc) != n_cases:
            raise ValueError(
                f'per-case start_rc has {len(start_rc)} entries for '
                f'{n_cases} cases')
    if per_case_starts:
        prepared = [prepare_starts(start_rc[i], valid)
                    for i in range(n_cases)]
    else:
        prepared = [prepare_starts(start_rc, valid)] * n_cases
    if dev_for is not None:
        moved = {}
        prepared = list(prepared)
        for i in range(n_cases):
            ck = (id(prepared[i][0]), dev_for[i])
            if ck not in moved:
                s, v = prepared[i]
                moved[ck] = (jax.device_put(s, dev_for[i]),
                             None if v is None
                             else jax.device_put(v, dev_for[i]))
            prepared[i] = moved[ck]

    states = {}
    for i in range(n_cases):
        starts_d, valid_d = prepared[i]
        states[i] = init_state(params, starts_d, keys[i], valid=valid_d)
    steps_done = {i: 0 for i in range(n_cases)}
    presence = {}
    steps = {}
    active = list(range(n_cases))
    while active:
        # enqueue phase: one chunk (or the whole tail) per active case,
        # no host reads — the device queue fills before anything blocks
        reads = []
        for i in active:
            cur = states[i].pos_r.shape[0]
            if tail_switch > 0 and cur <= tail_switch:
                st, _ = _run_tail(params, base_tables[i], dirp_list[i],
                                  table_list[i], states[i], chunk)
                presence[i] = _presence_out(params, st.presence)
                steps[i] = st.step  # tail flushed internally
                continue
            st, n_alive_dev = _run_chunk(params, base_tables[i],
                                         dirp_list[i], table_list[i],
                                         states[i], chunk)
            states[i] = st
            steps_done[i] += chunk
            reads.append((i, n_alive_dev))
        # read phase: each int() blocks until that case's chunk is done,
        # while the device drains the other cases' enqueued chunks
        active = []
        for i, n_alive_dev in reads:
            n_alive = int(n_alive_dev)
            if steps_done[i] >= params.nsteps or n_alive == 0:
                presence[i], steps[i] = _final_flush(params, states[i])
                continue
            cur = states[i].pos_r.shape[0]
            if cur > min_bucket:
                m = _bucket_for(n_alive, min_bucket)
                if m < cur:
                    states[i] = _compact(params, states[i], m)
            active.append(i)
    if dev_for is not None:
        # gather per-case results onto one device before stacking
        # (jnp.stack refuses mixed committed placements)
        presence = {i: jax.device_put(presence[i], devices[0])
                    for i in presence}
        steps = {i: jax.device_put(steps[i], devices[0])
                 for i in steps}
    return (jnp.stack([presence[i] for i in range(n_cases)]),
            jnp.stack([steps[i] for i in range(n_cases)]))
