"""Suppression coverage for the four rules: the same defective captures as
the bad_hlo_* fixtures (two of them for hlo-plan-drift), each with the standard `# lint: allow(<rule>)`
comment on its anchor line.  `--hlo` on this file must report zero
findings."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _hlo_fixture_lib


def _anchored(cap, fn):
    cap.anchor_line = fn.__code__.co_firstlineno
    return cap


def drift(num_devices):  # lint: allow(hlo-plan-drift)
    return _anchored(_hlo_fixture_lib.drift_capture(
        num_devices, workload="suppressed_plan_drift"), drift)


def unreduced(num_devices):  # lint: allow(hlo-plan-drift)
    return _anchored(_hlo_fixture_lib.unreduced_capture(
        num_devices, workload="suppressed_plan_drift_unreduced"), unreduced)


def replicated(num_devices):  # lint: allow(hlo-replicated-optstate)
    return _anchored(_hlo_fixture_lib.good_capture(
        num_devices, opt_replicated=True,
        workload="suppressed_replicated_optstate"), replicated)


def sync(num_devices):  # lint: allow(hlo-sync-collective)
    return _anchored(_hlo_fixture_lib.good_capture(
        num_devices, overlap=True, workload="suppressed_sync_collective"),
        sync)


def infeasible(num_devices):  # lint: allow(hlo-memory-infeasible)
    return _anchored(_hlo_fixture_lib.good_capture(
        num_devices, budget_bytes=1024,
        workload="suppressed_memory_infeasible"), infeasible)


def capture(num_devices):
    return [fn(num_devices)
            for fn in (drift, unreduced, replicated, sync, infeasible)]
