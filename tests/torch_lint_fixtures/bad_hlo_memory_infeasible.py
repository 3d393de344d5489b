"""Known-bad fixture: the step is correct, but the declared per-rank
memory budget (1 KiB) is far below what the rank holds.  `--hlo` must
flag hlo-memory-infeasible exactly once and nothing else."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _hlo_fixture_lib


def capture(num_devices):
    cap = _hlo_fixture_lib.good_capture(
        num_devices, budget_bytes=1024,
        workload="bad_hlo_memory_infeasible")
    cap.anchor_line = capture.__code__.co_firstlineno
    return cap
