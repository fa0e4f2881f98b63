"""One cell's studies through the public ``Simulator`` API.

A study is the calls a user makes for the cell's wind mode:

- uniform: ``compute_orographic_updraft_uniform()`` ->
  ``simulate_tracks()`` -> ``compute_presence_map()``;
- sweep: ``simulate_direction_sweep(dirns)`` -> ``compute_presence_map()``.

Before each study the study's artifacts are deleted (otherwise the
Simulator's saved-potential cache would skip the solves) and the track
seed is set from the run's seed and the study's index. Each call and the
study sit in ``jax.profiler.TraceAnnotation`` spans, which a traced run
reads on the profiler's clock.

``Captures`` records, for the correctness check, what the study's device
path consumed and produced beyond its artifacts: the conductivity each
potential solve was given and the move-weight tables the engine ran on.
It wraps the program's two potential solvers (the device refined solve
and the host float64 direct solve), the single-case engine's prologue and
the multi-case table build, and keeps references only; nothing is copied
inside the study.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import socket
import sys
import time


def derive_seed(seed: int, label) -> int:
    """A 31-bit seed from the run's seed and a label (JAX's keys take
    32 bits, and the run's seed may be larger)."""
    digest = hashlib.sha256(f'{int(seed)}:{label}'.encode()).digest()
    return int.from_bytes(digest[:4], 'little') & 0x7FFFFFFF


def go_offline() -> None:
    """Run the program with no network: the terrain and turbine clients
    find no ``requests`` module (and fall back to the offline synthetic
    DEM and to no turbines), and a socket may connect only to this
    host."""
    for mod in ('requests', 'h5pyd'):
        sys.modules[mod] = None
    real_connect = socket.socket.connect
    if getattr(real_connect, 'local_only', False):
        return

    def local_only(self, address):
        host = address[0] if isinstance(address, tuple) else address
        if isinstance(host, str) and host not in (
                'localhost', '127.0.0.1', '::1') and \
                not host.startswith('/'):
            raise OSError(f'network access refused by the benchmark: '
                          f'{address!r}')
        return real_connect(self, address)
    local_only.local_only = True
    socket.socket.connect = local_only


def simulator_config(cfg: dict, wl: dict, out_dir: str, seed: int) -> dict:
    """Simulator keyword arguments of a configuration and a workload."""
    kw = dict(cfg['simulator'])
    kw.update(wl.get('simulator', {}))
    kw.update(run_name=wl['name'], out_dir=out_dir,
              sim_seed=derive_seed(seed, 'starts'),
              track_count=int(wl['tracks']))
    for key in ('southwest_lonlat', 'region_width_km', 'track_start_region'):
        kw[key] = tuple(kw[key])
    return kw


class Captures:
    """References to what the device path consumed and produced."""

    def __init__(self):
        self.conductivity = []   # one per potential solve, in call order
        self.solve_seconds = []  # host wall inside each solve call
        self.tables = []         # engine weight tables, (C, ncells, 9)
        self._undo = []

    def clear(self):
        self.conductivity = []
        self.solve_seconds = []
        self.tables = []

    def install(self):
        import ssrs_tpu.agents
        import ssrs_tpu.agents.simulate as simulate
        import ssrs_tpu.potential
        import ssrs_tpu.potential.direct

        def wrap(module, name, on_call):
            orig = getattr(module, name)

            def spy(*args, **kwargs):
                t0 = time.perf_counter()
                with span(name):
                    out = orig(*args, **kwargs)
                on_call(args, out, time.perf_counter() - t0)
                return out
            setattr(module, name, spy)
            self._undo.append((module, name, orig))

        for module, name in ((ssrs_tpu.potential, 'solve_potential_refined'),
                             (ssrs_tpu.potential.direct,
                              'solve_potential_direct')):
            wrap(module, name, self._on_solve)
        wrap(simulate, '_prologue_jit',
             lambda a, out, _: self.tables.append(out[0][None]))
        wrap(ssrs_tpu.agents, 'prepared_weights_batch',
             lambda a, out, _: self.tables.append(out))

    def _on_solve(self, args, out, seconds):
        self.conductivity.append(args[0])
        self.solve_seconds.append(seconds)

    def uninstall(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo = []


class CompileCounter:
    """Counts executables built (compiled or loaded from the persistent
    cache) while active, from JAX's monitoring events."""

    EVENT = '/jax/core/compile/backend_compile_duration'

    def __init__(self):
        self.count = 0
        self.seconds = 0.

    def __call__(self, event, duration, **_):
        if event == self.EVENT:
            self.count += 1
            self.seconds += duration

    def __enter__(self):
        import jax
        jax.monitoring.register_event_duration_secs_listener(self)
        return self

    def __exit__(self, *exc):
        from jax._src import monitoring
        monitoring.unregister_event_duration_listener(self)


def span(name):
    import jax
    return jax.profiler.TraceAnnotation(name)


def clear_artifacts(sim) -> None:
    """Delete every artifact of the previous study."""
    data = sim.mode_data_dir
    for fname in os.listdir(data):
        path = os.path.join(data, fname)
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)


def run_study(sim, wl: dict, seed: int, index: int, captures: Captures):
    """One whole study. Returns (wall seconds, summary presence map,
    the study's PhaseTimer records)."""
    with span('artifact_cleanup'):
        clear_artifacts(sim)
        captures.clear()
    sim.sim_seed = derive_seed(seed, index)
    n_rec = len(sim.timer.records)
    t0 = time.perf_counter()
    with span('study'):
        if wl['study'] == 'uniform':
            with span('fields_call'):
                sim.compute_orographic_updraft_uniform()
            with span('tracks_call'):
                sim.simulate_tracks()
        elif wl['study'] == 'sweep':
            with span('sweep_call'):
                sim.simulate_direction_sweep(
                    [float(d) for d in wl['directions']])
        else:
            raise ValueError(f'unknown study {wl["study"]!r}')
        with span('presence_map_call'):
            summary = sim.compute_presence_map()
    wall = time.perf_counter() - t0
    return wall, summary, sim.timer.records[n_rec:]


@contextlib.contextmanager
def program_output_to_stderr():
    """The program's progress prints go to stderr, so that stdout holds
    the harness's lines and ends with the result line."""
    with contextlib.redirect_stdout(sys.stderr):
        yield
