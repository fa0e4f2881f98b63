"""The engine's algorithmic bytes per useful agent-step, by hand."""

from benchmark.roofline import engine_bytes_per_agent_step


def test_float32_table_one_move_memory():
    # table row 9 x 4; state r/w 2 x (row 4 + col 4 + memory 4 + alive 1
    # + previous-alive 4) = 34; presence read + write 8
    assert engine_bytes_per_agent_step(4, 1) == 36 + 34 + 8


def test_bfloat16_table_two_move_memory():
    # table row 9 x 2; state 2 x (4 + 4 + 8 + 1 + 4) = 42; presence 8
    assert engine_bytes_per_agent_step(2, 2) == 18 + 42 + 8


def test_no_memory_still_carries_one_slot():
    assert engine_bytes_per_agent_step(4, 0) == engine_bytes_per_agent_step(
        4, 1)
