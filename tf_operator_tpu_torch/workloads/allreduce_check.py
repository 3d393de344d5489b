"""Distributed-backend check workload: real multi-process collectives.

The counterpart of `tf_operator_tpu/workloads/allreduce_check.py`: every
replica joins the job's process group from the controller-injected
coordinator address and process id (`WorkloadContext.
initialize_distributed`: NCCL on the card, gloo on the CPU), all-gathers
process_id + 1 and checks that the sum is n(n + 1)/2 — the collective path
itself, not env parsing.  A job of one process has nothing to verify and
exits 0, as the JAX workload does.  Exit 0 iff the collective returns the
expected value.

NCCL refuses two ranks on one GPU, so on a one-card machine this check runs
at one process; its multi-process form is the gloo run on the CPU.

Usage: python -m tf_operator_tpu_torch.workloads.allreduce_check
"""
from __future__ import annotations

import sys


def main() -> int:
    from .runner import WorkloadContext, apply_forced_platform

    try:
        device = apply_forced_platform()
    except RuntimeError as e:
        print(f"allreduce_check: {e}", flush=True)
        return 1

    ctx = WorkloadContext.from_env()
    print(
        f"allreduce_check: role={ctx.replica_type} index={ctx.replica_index} "
        f"pid={ctx.process_id} nproc={ctx.num_processes} "
        f"coord={ctx.coordinator_address}",
        flush=True,
    )
    if ctx.num_processes <= 1 or ctx.process_id is None:
        print("single process; nothing to verify", flush=True)
        return 0

    import torch
    import torch.distributed as dist

    ctx.initialize_distributed(device)
    try:
        world = dist.get_world_size()
        print(f"initialized: process {dist.get_rank()}/{world}, backend "
              f"{dist.get_backend()}, device {device}", flush=True)
        if world != ctx.num_processes:
            print(f"FAIL: group of {world} processes, expected "
                  f"{ctx.num_processes}", flush=True)
            return 1
        mine = torch.tensor([ctx.process_id + 1], dtype=torch.int32,
                            device=device)
        gathered = [torch.zeros_like(mine) for _ in range(world)]
        dist.all_gather(gathered, mine)
        ranks = [t.cpu().tolist() for t in gathered]
    finally:
        dist.destroy_process_group()
    total = sum(r[0] for r in ranks)
    expected = ctx.num_processes * (ctx.num_processes + 1) // 2
    print(f"allgather ranks={ranks} sum={total} expected={expected}",
          flush=True)
    if total != expected:
        return 1
    print("allreduce_check OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
