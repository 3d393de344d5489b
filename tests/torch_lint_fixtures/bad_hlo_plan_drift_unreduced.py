"""Known-bad fixture: the ZeRO step gathers every updated slice back and
all-reduces its loss, but skips the gradients' reduce-scatter — each rank
updates its slice from its own gradient.  `--hlo` must flag
hlo-plan-drift exactly once (the reductions sum less than the sharded
entries' gradient bytes) and nothing else."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _hlo_fixture_lib


def capture(num_devices):
    cap = _hlo_fixture_lib.unreduced_capture(
        num_devices, workload="bad_hlo_plan_drift_unreduced")
    cap.anchor_line = capture.__code__.co_firstlineno
    return cap
