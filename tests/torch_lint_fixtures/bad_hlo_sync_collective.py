"""Known-bad fixture: every sharded plan entry is marked overlappable
(`ZeroShardingPlan.with_overlap`), but the step gathers the updated
slices with async_op=False — the promised compute/communication overlap
cannot happen.  `--hlo` must flag hlo-sync-collective exactly once and
nothing else."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _hlo_fixture_lib


def capture(num_devices):
    cap = _hlo_fixture_lib.good_capture(
        num_devices, overlap=True, workload="bad_hlo_sync_collective")
    cap.anchor_line = capture.__code__.co_firstlineno
    return cap
