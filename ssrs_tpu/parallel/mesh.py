"""Multi-device scaling: agents sharded over a device mesh.

The reference's entire parallelism surface is a host process pool with one
task per agent (ssrs/simulator.py:347,360-381; inventory in SURVEY.md SS2).
The device equivalent is pure data parallelism over agents:

- the agent batch is sharded over a 1-D mesh axis ``'agents'``;
- field tables (updraft-derived move weights, potential) are replicated —
  they are at most a few hundred MB at 30 m resolution;
- the only cross-device communication in the whole simulation is ONE
  ``psum`` of the per-device presence histograms at the end;
- per-device RNG streams are derived by folding the mesh axis index into
  the step key, so results are deterministic for a fixed mesh size.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..agents.simulate import (SimState, TrackParams, _bucket_for,
                               _compact, _norm_tail_bucket, _run_chunk,
                               _run_tail, directional_probs,
                               flush_pending, init_state,
                               prepared_weights, restriction_table,
                               simulate_presence)


def make_mesh(n_devices: int = 0, devices=None) -> Mesh:
    """1-D mesh over the ``'agents'`` axis. ``n_devices`` <= 0 uses all
    local devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices and n_devices > 0:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=('agents',))


def pad_to_multiple(starts: np.ndarray, multiple: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the agent batch so it divides evenly across devices; padding
    agents are marked invalid (they start dead and contribute nothing)."""
    n = starts.shape[0]
    n_pad = (-n) % multiple
    valid = np.ones(n + n_pad, dtype=bool)
    if n_pad:
        starts = np.concatenate(
            [starts, np.broadcast_to(starts[-1:], (n_pad, 2))], axis=0)
        valid[n:] = False
    return np.ascontiguousarray(starts), valid


def sharded_presence_fn(params: TrackParams, mesh: Mesh,
                        chunk: int = 128, has_updraft: bool = True,
                        has_potential: bool = True):
    """Build the shard-mapped simulation callable over ``mesh``.

    The returned function takes ``(starts, valid, key[, updraft
    [, potential]])`` with the agent axis sharded and fields replicated,
    and returns globally-summed ``(presence, steps)``. Exposed separately
    from :func:`simulate_presence_sharded` so callers (weak-scaling
    evidence in ``scripts/weak_scaling.py``, tests) can ``jax.jit(...)
    .lower(...)`` it and assert the collective schedule — one presence
    ``psum`` + one step-count ``pmax`` and nothing else.
    """

    if has_potential and not has_updraft:
        raise ValueError('potential requires updraft (the fluidflow '
                         'weight table is built from both)')

    def shard_body(starts_l, valid_l, key_r, *fields):
        updraft_r = fields[0] if has_updraft else None
        potential_r = fields[int(has_updraft)] if has_potential else None
        # distinct per-device stream, deterministic for a fixed mesh size
        key_l = jax.random.fold_in(key_r, jax.lax.axis_index('agents'))
        presence, steps = simulate_presence(
            params, starts_l, key_l, updraft=updraft_r,
            potential=potential_r, chunk=chunk, valid=valid_l)
        return (jax.lax.psum(presence, 'agents'),
                jax.lax.pmax(steps, 'agents'))

    in_specs = [P('agents'), P('agents'), P()]
    in_specs += [P(None, None)] * (int(has_updraft) + int(has_potential))
    return jax.shard_map(shard_body, mesh=mesh, in_specs=tuple(in_specs),
                         out_specs=(P(), P()))


def simulate_presence_sharded(params: TrackParams,
                              start_rc: np.ndarray,
                              key: jax.Array,
                              updraft: Optional[jax.Array] = None,
                              potential: Optional[jax.Array] = None,
                              mesh: Optional[Mesh] = None,
                              chunk: int = 128):
    """Run the lockstep simulation with agents sharded over the mesh.

    Returns (presence int32 (nrow, ncol) — globally summed, steps int32).
    """
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    starts, valid = pad_to_multiple(np.asarray(start_rc, np.int32), n_dev)

    if potential is not None and updraft is None:
        raise ValueError('potential requires updraft (the fluidflow '
                         'weight table is built from both)')
    mapped = sharded_presence_fn(params, mesh, chunk,
                                 has_updraft=updraft is not None,
                                 has_potential=potential is not None)
    args = [jnp.asarray(starts), jnp.asarray(valid), key]
    if updraft is not None:
        args.append(jnp.asarray(updraft))
    if potential is not None:
        args.append(jnp.asarray(potential))
    return mapped(*args)


# ---- compacting sharded driver (VERDICT r3 item 2) ----------------------
#
# The plain sharded engine above keeps every agent slot alive for the
# whole run: the single-chip compacting driver's measured 2-3x win (up
# to ~80% of slots dead by mid-run) vanished the moment a mesh
# appeared. This section ports the host-orchestrated bucket ladder to
# the mesh: each shard packs ITS OWN survivors (no cross-device agent
# migration — the weight tables are replicated, so a survivor is
# equally at home on its current device), and all shards shrink to the
# same next bucket in lockstep, sized by the pmax'd per-shard alive
# count (SPMD needs one static shape across shards). Collectives per
# chunk round: ONE scalar pmax; at the end: one presence psum + one
# steps pmax — same bound as the non-compacting engine, asserted in
# tests/test_parallel.py::test_compacting_sharded_collective_schedule.
#
# The per-shard state between rounds is a tuple of globally-sharded
# arrays (agent axis over 'agents'; per-shard PRNG keys and presence
# partials stacked on a leading device axis). The shard bodies are thin
# wrappers around the SAME jitted pieces the single-chip driver runs
# (_run_chunk / _compact / _run_tail), so per-shard semantics are
# identical by construction.

_STATE_AXES = ('pos_r', 'pos_c', 'mem', 'alive', 'palive', 'keys',
               'presence')


def _state_specs() -> tuple:
    """PartitionSpecs of the inter-round state tuple (order:
    pos_r, pos_c, mem, alive, palive, keys, presence)."""
    return (P('agents'), P('agents'), P(None, 'agents'), P('agents'),
            P('agents'), P('agents'), P('agents', None, None))


def _pack(st: SimState):
    """SimState -> inter-round tuple (shard-local view, leading device
    axis of size 1 on keys/presence)."""
    return (st.pos_r, st.pos_c, st.mem, st.alive, st.palive,
            st.key[None], st.presence[None])


def _unpack(tup, step) -> SimState:
    pos_r, pos_c, mem, alive, palive, keys, presence = tup
    return SimState(pos_r=pos_r, pos_c=pos_c, mem=mem, alive=alive,
                    palive=palive, key=keys[0], presence=presence[0],
                    step=step)


@functools.lru_cache(maxsize=None)
def _init_sharded_fn(params: TrackParams, mesh: Mesh):
    def body(starts_l, valid_l, key_r):
        key_l = jax.random.fold_in(key_r, jax.lax.axis_index('agents'))
        st = init_state(params, starts_l, key_l, valid=valid_l)
        return _pack(st)

    mapped = jax.shard_map(body, mesh=mesh,
                           in_specs=(P('agents'), P('agents'), P()),
                           out_specs=_state_specs())
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _round_sharded_fn(params: TrackParams, mesh: Mesh, chunk: int,
                      has_table: bool):
    """One chunk round on every shard + the lockstep bucket signal
    (pmax of per-shard alive counts) — the round's only collective."""

    def body(state_tup, step0, *fields):
        base_flat = fields[0] if has_table else None
        dirp, table = fields[-2], fields[-1]
        st = _unpack(state_tup, step0)
        st, n_alive = _run_chunk(params, base_flat, dirp, table, st,
                                 chunk)
        max_alive = jax.lax.pmax(n_alive, 'agents')
        return _pack(st), max_alive

    # field specs in order: [base_flat (nrow*ncol, 9)], dirp (9,),
    # table (9, 9) — all replicated
    in_specs = (_state_specs(), P(),
                *((P(None, None),) if has_table else ()),
                P(None), P(None, None))
    mapped = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                           out_specs=(_state_specs(), P()))
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _compact_sharded_fn(params: TrackParams, mesh: Mesh, m: int):
    """Each shard packs its own survivors to the front and truncates to
    the common bucket ``m`` (>= the pmax'd alive count, so no survivor
    is dropped). Flushes the pending delayed-presence update first,
    like the single-chip _compact."""

    def body(state_tup, step0):
        st = _unpack(state_tup, step0)
        st = _compact(params, st, m)
        return _pack(st)

    mapped = jax.shard_map(body, mesh=mesh,
                           in_specs=(_state_specs(), P()),
                           out_specs=_state_specs())
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _tail_sharded_fn(params: TrackParams, mesh: Mesh, chunk: int,
                     has_table: bool):
    """Run every shard's remainder in one dispatch (device-side
    while_loop with per-shard early exit — shards may run different
    trip counts; there is no collective inside the divergent region)
    and reduce: presence psum + steps pmax."""

    def body(state_tup, step0, *fields):
        base_flat = fields[0] if has_table else None
        dirp, table = fields[-2], fields[-1]
        st = _unpack(state_tup, step0)
        st, _ = _run_tail(params, base_flat, dirp, table, st, chunk)
        return (jax.lax.psum(st.presence, 'agents'),
                jax.lax.pmax(st.step, 'agents'))

    in_specs = (_state_specs(), P(),
                *((P(None, None),) if has_table else ()),
                P(None), P(None, None))
    mapped = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                           out_specs=(P(), P()))
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _finalize_sharded_fn(params: TrackParams, mesh: Mesh):
    def body(state_tup, step0):
        st = _unpack(state_tup, step0)
        st = flush_pending(params, st)
        return (jax.lax.psum(st.presence, 'agents'),
                jax.lax.pmax(st.step, 'agents'))

    mapped = jax.shard_map(body, mesh=mesh,
                           in_specs=(_state_specs(), P()),
                           out_specs=(P(), P()))
    return jax.jit(mapped)


def simulate_presence_sharded_compacting(
        params: TrackParams, start_rc, key: jax.Array,
        updraft=None, potential=None, mesh: Optional[Mesh] = None,
        chunk: int = 512, min_bucket: int = 1024, tail_bucket=0):
    """Sharded presence simulation WITH dead-agent compaction and the
    one-dispatch tail — the mesh port of
    ``simulate_presence_compacting`` (same bucket ladder, same chunk
    semantics, per-shard RNG streams as in the plain sharded engine).

    ``tail_bucket``: 0 (default) switches to the tail at min_bucket; a
    positive int switches at that per-shard bucket; negative never
    switches; 'auto' is accepted and treated as the min_bucket switch
    (the measured round-trip rule is a single-device policy).

    Returns (presence int32 (nrow, ncol) — globally summed,
    steps int32).
    """
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    has_table = updraft is not None
    if potential is not None and not has_table:
        raise ValueError('potential requires updraft (the fluidflow '
                         'weight table is built from both)')
    starts, valid = pad_to_multiple(np.asarray(start_rc, np.int32), n_dev)
    tail_switch = _norm_tail_bucket(tail_bucket, min_bucket)

    dirp = jnp.asarray(directional_probs(params.move_dirn))
    table = jnp.asarray(restriction_table())
    if has_table:
        base_flat = prepared_weights(updraft, potential, dirp,
                                     params.weight_dtype)
        fields = (base_flat, dirp, table)
    else:
        fields = (dirp, table)

    state = _init_sharded_fn(params, mesh)(
        jnp.asarray(starts), jnp.asarray(valid), key)
    steps_done = 0
    step0 = jnp.asarray(0, jnp.int32)
    max_alive = starts.shape[0] // n_dev  # optimistic, like single-chip
    round_fn = _round_sharded_fn(params, mesh, chunk, has_table)
    nrow, ncol = params.grid_shape
    while steps_done < params.nsteps and max_alive > 0:
        bucket = state[0].shape[0] // n_dev
        if tail_switch > 0 and bucket <= tail_switch:
            presence, steps = _tail_sharded_fn(
                params, mesh, chunk, has_table)(state, step0, *fields)
            return presence[:nrow, :ncol], steps
        state, max_alive_dev = round_fn(state, step0, *fields)
        steps_done += chunk
        step0 = jnp.asarray(steps_done, jnp.int32)
        max_alive = int(max_alive_dev)   # ONE host read per round
        bucket = state[0].shape[0] // n_dev
        if max_alive > 0 and bucket > min_bucket:
            m = _bucket_for(max_alive, min_bucket)
            if m < bucket:
                state = _compact_sharded_fn(params, mesh, m)(state,
                                                             step0)
    presence, steps = _finalize_sharded_fn(params, mesh)(state, step0)
    return presence[:nrow, :ncol], steps
