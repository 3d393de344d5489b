"""Known-bad fixture: the declared ZeRO plan shards the optimizer state,
but every rank keeps each parameter's whole momentum — the dense-optimizer
regression ZeRO exists to prevent.  `--hlo` must flag
hlo-replicated-optstate exactly once and nothing else."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _hlo_fixture_lib


def capture(num_devices):
    cap = _hlo_fixture_lib.good_capture(
        num_devices, opt_replicated=True,
        workload="bad_hlo_replicated_optstate")
    cap.anchor_line = capture.__code__.co_firstlineno
    return cap
