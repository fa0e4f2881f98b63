"""The correctness check's control, on the chip: a run of a cell with one
precision step below the stated one in the program's place (the
program's own bfloat16 move-weight table, and the reference in bfloat16
or float32 for the fields, the solve and the presence smoothing). It has
to read ``"correct": false``; the numbers it prints are the upper
readings the cell's limits are set under. The benchmark's own runs never
run it.

    python benchmark/control.py --workload <cell> --seed <n> --seconds <s> \
        --trace 0
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run  # noqa: E402

if __name__ == '__main__':
    sys.exit(run.main(control=True))
