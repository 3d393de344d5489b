"""python -m tf_operator_tpu_torch.analysis --hlo TARGET [options]

TARGET is a workload (lm, resnet, bert, vit), `all`, or a capture fixture
(a .py file with `capture(num_devices)`).  The command starts N ranks of
itself through the pod launcher (`workloads/launch.spawn`), one per device,
even at N = 1 (a capture needs a process group): on CUDA one per GPU over
NCCL, on the CPU under TPUJOB_FORCE_PLATFORM=cpu over gloo; each rank runs
`analysis/hlo.run_hlo`.  N is --devices, else `hlo.default_devices()`.
Exit 0 when clean, 1 on a finding, on manifest drift or without a CUDA
device when the CPU was not asked for.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from ..api import constants
    from ..workloads.launch import spawn
    from . import hlo

    argv = list(sys.argv[1:] if argv is None else argv)

    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.analysis",
        description="the train step's collective inventory, its four rules "
                    "and its manifest (analysis/hlo.py)",
    )
    parser.add_argument("--hlo", required=True, metavar="TARGET",
                        help="record+check one train step of a workload "
                             "name, 'all', or a capture-fixture .py path. "
                             "--json writes findings; --manifest --json "
                             "PATH writes the collective-signature "
                             "manifest; --diff PATH gates against the "
                             "committed tf_operator_tpu_torch/analysis/"
                             "collective-manifest.json")
    parser.add_argument("--devices", type=int, default=None,
                        help="ranks of the capture, one per device "
                             "(default: $ANALYSIS_HLO_DEVICES, else the "
                             "GPUs, or on the CPU $TPUJOB_CPU_DEVICE_COUNT, "
                             "else 4)")

    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to report (default: "
                             "all)")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write machine-readable findings to PATH; "
                             "with --manifest, write the manifest there "
                             "instead")
    parser.add_argument("--manifest", action="store_true",
                        help="write the collective-signature manifest "
                             "(to --json PATH)")
    parser.add_argument("--diff", default=None, metavar="PATH",
                        help="compare the regenerated manifest against the "
                             "committed one at PATH and exit 1 on drift")
    args = parser.parse_args(argv)

    wanted = None
    if args.rules is not None:
        wanted = {r for r in args.rules.split(",") if r}
        unknown = wanted - set(hlo.HLO_RULES)
        if unknown:
            raise SystemExit(f"unknown rule(s): {', '.join(sorted(unknown))}")
    if args.manifest and args.json is None:
        parser.error("--hlo --manifest requires --json PATH (the manifest "
                     "output file)")
    if constants.ENV_LOCAL_RANK not in os.environ:
        # the pod's parent: each rank takes its device (and says when
        # there is none)
        return spawn([sys.executable, "-m", "tf_operator_tpu_torch.analysis",
                      *argv], args.devices or hlo.default_devices())
    return hlo.run_hlo(
        args.hlo,
        json_path=None if args.manifest else args.json,
        manifest_path=args.json if args.manifest else None,
        diff_path=args.diff,
        rules=wanted,
    )


if __name__ == "__main__":
    sys.exit(main())
