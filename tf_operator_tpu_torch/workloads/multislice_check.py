"""Multislice topology verification workload.

The counterpart of `tf_operator_tpu/workloads/multislice_check.py`.  The
controller's topology injector gives a worker group that spans several
slices a MEGASCALE document (controller/topology.py:_add_multislice_env):
the DCN coordinator, the slice count and this process's slice id.  libtpu
consumes it on a TPU; a GPU job has no analogue (NCCL finds its peers
through the process group's store), so the port reads the same env and
verifies the layout over torch.distributed.  Every replica

  1. joins the job's process group from the injected coordinator env,
  2. all-gathers its (process_id, slice_id) over that live group, as host
     data (a gloo group beside an NCCL one, as JAX's process_allgather
     gathers numpy arrays), and
  3. verifies the assembled view, in the JAX workload's order: the slices
     seen, the packing slice = process_id // hosts, the per-slice counts,
     one DCN document on every process, and that the DCN coordinator is
     worker 0's host (cross-checked against the TF_CONFIG worker[0]
     address, not a string a test hard-codes)

so a wrong slice-id layout or coordinator choice fails by behavior on every
process.  Exit 0 iff every check passes.
"""
from __future__ import annotations

import os
import sys

from ..api import constants


def main() -> int:
    from ..api.topology import topology_hosts
    from .runner import WorkloadContext, apply_forced_platform

    try:
        device = apply_forced_platform()
    except RuntimeError as e:
        print(f"multislice_check: {e}", flush=True)
        return 1
    ctx = WorkloadContext.from_env()

    num_slices = int(os.environ.get(constants.ENV_MEGASCALE_NUM_SLICES, "1"))
    slice_id = int(os.environ.get(constants.ENV_MEGASCALE_SLICE_ID, "0"))
    dcn_coord = os.environ.get(constants.ENV_MEGASCALE_COORDINATOR, "")
    print(
        f"multislice_check: index={ctx.replica_index} pid={ctx.process_id} "
        f"slice={slice_id}/{num_slices} dcn_coord={dcn_coord}",
        flush=True,
    )
    if num_slices < 2:
        print("single slice; no DCN document expected", flush=True)
        return 0 if not dcn_coord else 1

    hosts = topology_hosts(ctx.slice_topology)

    # 1. the global group must actually form over the injected coordinator
    import torch.distributed as dist

    ctx.initialize_distributed(device)
    try:
        return _check(ctx, num_slices, slice_id, dcn_coord, hosts)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _allgather(group, values, dtype):
    """[world, len(values)] of every process's `values`, over the host
    group."""
    import torch
    import torch.distributed as dist

    mine = torch.tensor(values, dtype=dtype)
    out = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine, group=group)
    return torch.stack(out)


def _check(ctx, num_slices: int, slice_id: int, dcn_coord: str,
           hosts: int) -> int:
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        print("FAIL: a multislice group needs the process-group env "
              "(coordinator, process id, process count)", flush=True)
        return 1
    # host data goes over gloo, beside an NCCL default group on the card
    group = (None if dist.get_backend() == "gloo"
             else dist.new_group(backend="gloo"))

    # 2. carry (process_id, slice_id) over the live collective
    table = _allgather(group, [ctx.process_id, slice_id], torch.int32)
    table = table.tolist()  # [num_processes, 2]
    print(f"fabric table: {table}", flush=True)

    # 3a. the fabric has exactly the advertised number of slices
    seen_slices = sorted(set(r[1] for r in table))
    if seen_slices != list(range(num_slices)):
        print(f"FAIL: slices seen {seen_slices} != 0..{num_slices - 1}",
              flush=True)
        return 1
    # 3b. slice membership is the scheduler's packing: slice = index // hosts,
    # each slice fully populated
    for pid, sid in table:
        if pid // hosts != sid:
            print(f"FAIL: process {pid} claims slice {sid}, packing says "
                  f"{pid // hosts}", flush=True)
            return 1
    counts = {s: sum(1 for r in table if r[1] == s) for s in seen_slices}
    if any(c != hosts for c in counts.values()):
        print(f"FAIL: per-slice host counts {counts} != {hosts}", flush=True)
        return 1
    # 3c. every process got the SAME dcn coordinator document
    coords = _allgather(group, list(dcn_coord.ljust(64)[:64].encode()),
                        torch.uint8)
    if not bool((coords == coords[0]).all()):
        print("FAIL: processes disagree on the DCN coordinator", flush=True)
        return 1
    # 3d. the DCN coordinator is slice 0 host 0 — cross-checked against the
    # independently-injected TF_CONFIG cluster map (worker[0]'s address),
    # which the substrate resolved, not the test
    if ctx.tf_config:
        worker0 = ctx.tf_config["cluster"]["worker"][0]
        host0 = worker0.rsplit(":", 1)[0]
        dcn_host = dcn_coord.rsplit(":", 1)[0]
        if dcn_host != host0:
            print(f"FAIL: DCN coordinator host {dcn_host} is not worker-0 "
                  f"host {host0}", flush=True)
            return 1
        if ctx.process_id == 0 and slice_id != 0:
            print("FAIL: process 0 is not on slice 0", flush=True)
            return 1
    print("multislice_check OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
