"""PRNG key plumbing.

The reference relies on global ``np.random.seed`` calls
(ssrs/simulator.py:50-52, 351-352) and unseeded worker processes, which are
not reproducible across pool configurations. This engine uses explicit
``jax.random`` keys with a documented fold-in hierarchy:

    root(seed) -> case -> realization -> {"potential","thermals","tracks"}

so the random streams are fixed for a fixed device count and shape. On
the CPU every artifact is then bit-reproducible; on the GPU the refined
potential solve's floating-point sums are not (they vary in the last
bits from run to run), and tracks sampled over a potential that differs
in its last bits are a different sample of the same distribution.
"""

from __future__ import annotations

import hashlib

import jax


def root_key(sim_seed: int) -> jax.Array:
    """Root key for a run; negative seeds (the reference's "unseeded" mode,
    ssrs/config.py:17) map to a fixed but distinct stream."""
    return jax.random.key(sim_seed if sim_seed >= 0 else 0x5539)


def fold_str(key: jax.Array, name: str) -> jax.Array:
    """Deterministically fold a string label into a key."""
    digest = hashlib.sha256(name.encode('utf-8')).digest()
    tag = int.from_bytes(digest[:4], 'little')
    return jax.random.fold_in(key, tag)


def case_key(sim_seed: int, case_id: str, real_id: int, stream: str) -> jax.Array:
    """Key for one (case, realization, stream) triple."""
    key = root_key(sim_seed)
    key = fold_str(key, case_id)
    key = jax.random.fold_in(key, real_id)
    return fold_str(key, stream)
