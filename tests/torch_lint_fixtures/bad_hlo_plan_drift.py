"""Known-bad fixture: declares a ZeRO sharding plan but runs a step with
none of the plan's collectives — no gradient reduction, no weight-update
all-gather.  `--hlo` must flag hlo-plan-drift exactly once and nothing
else."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _hlo_fixture_lib


def capture(num_devices):
    cap = _hlo_fixture_lib.drift_capture(
        num_devices, workload="bad_hlo_plan_drift")
    cap.anchor_line = capture.__code__.co_firstlineno
    return cap
