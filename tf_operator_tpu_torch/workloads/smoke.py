"""Generic smoke workload — the tf_smoke.py analogue.

The counterpart of `tf_operator_tpu/workloads/smoke.py`: parse the injected
topology, join the job's process group when it has one
(`WorkloadContext.initialize_distributed`: NCCL on the card, gloo on the
CPU), run a bf16 n x n matmul of ones on the device, print the device and
the checksum, and exit 0 when it equals n^3 within 1e-2.  PS replicas only
need to be addressable and exit 0 at once.

Usage: python -m tf_operator_tpu_torch.workloads.smoke [--size 1024]
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=1024)
    args = parser.parse_args(argv)

    from .runner import WorkloadContext, apply_forced_platform

    try:
        device = apply_forced_platform()
    except RuntimeError as e:
        print(f"smoke: {e}", flush=True)
        return 1

    ctx = WorkloadContext.from_env()
    print(f"smoke: role={ctx.replica_type} index={ctx.replica_index} "
          f"tf_config={'yes' if ctx.tf_config else 'no'}", flush=True)
    if ctx.replica_type == "ps":
        # PS replicas only need to be addressable; nothing to compute.
        print("smoke PS parked OK", flush=True)
        return 0

    import torch
    import torch.distributed as dist

    joined = ctx.initialize_distributed(device)
    try:
        n = args.size
        x = torch.ones((n, n), dtype=torch.bfloat16, device=device)
        checksum = float(torch.matmul(x, x).float().sum())
    finally:
        if joined:
            dist.destroy_process_group()
    expected = float(n) ** 3
    name = (f"{device} ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else str(device))
    print(f"smoke matmul on {name}: checksum={checksum:.3e} "
          f"expected={expected:.3e}", flush=True)
    return 0 if abs(checksum - expected) / expected < 1e-2 else 1


if __name__ == "__main__":
    sys.exit(main())
