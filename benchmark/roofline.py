"""Algorithmic bytes of the agent engine, from the state's shapes.

One useful agent-step (an agent alive at the step) reads its cell's row
of the move-weight table, reads and writes its slice of the simulation
state, and read-modify-writes one presence cell:

- table row: 9 entries of the table's dtype;
- state, read and written: row and column (int32 each), the K-deep move
  memory (int32 each), the alive flag (1 byte) and the previous-alive
  weight (int32);
- presence: one int32 read and one int32 write.

The count ignores caches, the random key, dead slots the engine still
carries, compaction copies and every other overhead, so it is a LOWER
bound of the bytes the engine moves: a share of the HBM peak computed
from it can only read low.
"""

from __future__ import annotations


def engine_bytes_per_agent_step(table_itemsize: int, memory_k: int) -> int:
    table_row = 9 * table_itemsize
    state = 4 + 4 + 4 * max(memory_k, 1) + 1 + 4
    presence = 4 + 4
    return table_row + 2 * state + presence
