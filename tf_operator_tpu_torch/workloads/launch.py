"""The per-pod launcher: one process per local device.

A JAX pod process drives every device of its host: the workloads call
`jax.distributed.initialize` and lay their mesh over `jax.devices()`,
every device of every process.  A process of the port drives one GPU, so
a pod with L local devices runs L processes (torchrun's layout, done
here):

- L is `torch.cuda.device_count()`, the GPUs that the pod's
  CUDA_VISIBLE_DEVICES exposes.  Under TPUJOB_FORCE_PLATFORM=cpu it is
  TPUJOB_CPU_DEVICE_COUNT (default 1), the counterpart of XLA's forced
  host device count in the CPU tests; nothing else reads that variable.
- L = 1: the workload runs in this process, as a pod always did.
- L > 1: this process, the pod's parent, starts L children of its own
  command line (`sys.orig_argv`), child i with LOCAL_RANK=i and LOCAL_WORLD_SIZE=L; the
  TPUJOB_* variables stay the pod's.  Child i of pod p is global rank
  p x L + i of pods x L (`runner.WorkloadContext.rank`), the
  process-major order of `jax.devices()`: rank r sits at the mesh
  coordinate of JAX's device r, and `train/step.shard_batch` gives it the
  rows JAX gives that device.  Each child drives `cuda:<i>`; every GPU
  stays visible.  Global rank 0 serves the store at
  TPUJOB_COORDINATOR_ADDRESS (a one-pod job without one gets a free
  localhost port here), and the pods check there that they agree on L
  before the group forms.
- The children write to the pod's stdout: the lines each pod printed
  before come from local rank 0 (`runner.pod_say`), the training lines
  from global rank 0 (`runner.say`).  The parent prints the layout and
  the children's pids first, and the pod's exit code last.

The exit contract, which the ExitCode restart policy reads: the pod exits
0 when every child does; otherwise the first child that fails decides
the code (a child killed by signal N counts as 128 + N, so 137 and 143
stay retryable and 2 stays permanent), after the parent has stopped its
siblings (SIGTERM, then SIGKILL after a grace).  The parent wakes on
each child's SIGCHLD, so it takes each exit as it happens: a rank that
dies and the peers that fail on its broken collective a moment later are
told apart, and the pod exits with the death's code.  SIGTERM or SIGINT to the
parent alone (Kubernetes signals PID 1 only) is forwarded to every child,
and the pod exits 143 or 130.  The children stay in the pod's process
group, so a `killpg` of the pod (how `LocalProcessCluster` stops one)
reaches them too, and each child dies with its parent (PR_SET_PDEATHSIG),
so none outlives its pod.  A mesh that does not multiply to pods x L
exits 2 with JAX's message before any child starts.

The four training workloads (lm, resnet, vit, bert) start through
`run_pod`: their JAX counterparts mesh every device.  mnist, dist_mnist,
estimator, smoke, allreduce_check and multislice_check keep one process
per pod: their JAX counterparts build no mesh, or check at the process
level only (`process_allgather`).

    python -m tf_operator_tpu_torch.workloads.launch --local-ranks L \\
        [-m] TARGET [ARGS...]

starts L children of `python [-m] TARGET ARGS...` whatever the device
count (the entry with an explicit L), and exits by the same contract.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import select
import signal
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..api import constants
from .runner import WorkloadContext, print_line

# seconds a child gets between SIGTERM and SIGKILL when the pod stops it
GRACE_S = 10.0
_PR_SET_PDEATHSIG = 1


def local_device_count() -> int:
    """L: the CUDA devices this pod sees, or TPUJOB_CPU_DEVICE_COUNT under
    TPUJOB_FORCE_PLATFORM=cpu.  1 without a CUDA device, so the workload
    runs in this process and says why it cannot run."""
    if os.environ.get(constants.ENV_FORCE_PLATFORM, "").lower() == "cpu":
        return int(os.environ.get(constants.ENV_CPU_DEVICE_COUNT, "1"))
    import torch

    return max(1, torch.cuda.device_count())


def exit_code(returncode: int) -> int:
    """A child's exit as a container reports it: 128 + N for signal N."""
    return 128 - returncode if returncode < 0 else returncode


def run_pod(main: Callable[[List[str]], int],
            argv: Optional[Sequence[str]] = None) -> int:
    """A workload's `__main__`: `main(argv)` (default `sys.argv[1:]`) in
    this process when it is a child of the launcher or the pod has one
    local device, else the pod's parent over L children of this process's
    own command line."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if constants.ENV_LOCAL_RANK in os.environ:
        _die_with_launcher()
        return main(argv)
    count = local_device_count()
    if count == 1:
        return main(argv)
    return spawn([sys.executable, *sys.orig_argv[1:]], count)


def _die_with_launcher() -> None:
    """Have the kernel kill this process when the launcher that started it
    exits, and exit now if it already has."""
    parent = os.environ.get(constants.ENV_LAUNCHER_PID)
    if parent is None:
        return
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong, ctypes.c_ulong,
                           ctypes.c_ulong, ctypes.c_ulong]
    libc.prctl.restype = ctypes.c_int
    if libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")
    if os.getppid() != int(parent):
        os._exit(128 + signal.SIGKILL)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(command: List[str], local_count: int) -> int:
    """Run `command` as the pod's `local_count` local ranks under the exit
    contract above; returns the pod's exit code."""
    env = dict(os.environ)
    ctx = WorkloadContext.from_env(env)
    if local_count < 1:
        print_line(f"pod launcher: {local_count} local ranks; a pod runs at "
                   "least one")
        return 2
    pods, pod = ctx.num_processes, ctx.process_id or 0
    world = pods * local_count
    if ctx.mesh_shape:
        from ..parallel.mesh import build_mesh

        try:
            build_mesh(ctx.mesh_shape, world)
        except ValueError as e:
            print_line(f"invalid mesh: {e}")
            return 2
    if not env.get(constants.ENV_COORDINATOR_ADDRESS):
        if pods > 1:
            print_line(f"pod launcher: {pods} pods and no "
                       f"{constants.ENV_COORDINATOR_ADDRESS}")
            return 2
        env[constants.ENV_COORDINATOR_ADDRESS] = f"127.0.0.1:{_free_port()}"
    env[constants.ENV_LAUNCHER_PID] = str(os.getpid())
    env[constants.ENV_LOCAL_WORLD_SIZE] = str(local_count)
    first = pod * local_count
    print_line(f"pod launcher: {pods} pod(s) x {local_count} local rank(s), "
               f"world {world}; pod {pod} runs global ranks {first}-"
               f"{first + local_count - 1}")
    code = _supervise(command, env, local_count)
    print_line(f"pod launcher: exit {code}")
    return code


def _supervise(command: List[str], env: Dict[str, str], count: int) -> int:
    """The pod's code: the first signal forwarded, else the first child
    exit that is not 0, else 0.  A child's SIGCHLD (or a signal to the
    parent) wakes the parent through a wakeup pipe the moment it comes;
    exits that one wake-up finds together count in local-rank order."""
    children: List[subprocess.Popen] = []
    received: List[int] = []

    def forward(signum, frame):
        received.append(signum)
        for child in children:
            _signal(child, signum)

    wake_r, wake_w = os.pipe()
    for fd in (wake_r, wake_w):
        os.set_blocking(fd, False)
    previous = {s: signal.signal(s, forward)
                for s in (signal.SIGTERM, signal.SIGINT)}
    previous[signal.SIGCHLD] = signal.signal(signal.SIGCHLD,
                                             lambda signum, frame: None)
    previous_fd = signal.set_wakeup_fd(wake_w)
    try:
        for i in range(count):
            children.append(subprocess.Popen(
                command, env={**env, constants.ENV_LOCAL_RANK: str(i)}))
        print_line("pod launcher: local rank pids "
                   f"{[child.pid for child in children]}")
        while not received:
            codes = [child.poll() for child in children]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return exit_code(failed[0])
            if all(c == 0 for c in codes):
                return 0
            if select.select([wake_r], [], [], 1.0)[0]:
                os.read(wake_r, 4096)
        return 128 + received[0]
    finally:
        _stop(children)
        signal.set_wakeup_fd(previous_fd)
        for s, handler in previous.items():
            signal.signal(s, handler)
        os.close(wake_r)
        os.close(wake_w)


def _signal(child: subprocess.Popen, signum: int) -> None:
    if child.poll() is None:
        try:
            child.send_signal(signum)
        except ProcessLookupError:
            pass


def _stop(children: List[subprocess.Popen]) -> None:
    """SIGTERM to every child still running, SIGKILL to those left after
    the grace; returns once every child has exited."""
    for child in children:
        _signal(child, signal.SIGTERM)
    deadline = time.monotonic() + GRACE_S
    for child in children:
        try:
            child.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.workloads.launch",
        description="run a program as this pod's local ranks")
    parser.add_argument("--local-ranks", type=int, required=True,
                        help="L, the processes this pod runs")
    parser.add_argument("-m", dest="module", action="store_true",
                        help="TARGET is a module (python -m TARGET)")
    parser.add_argument("target")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    command = [sys.executable, *(["-m"] if args.module else []),
               args.target, *args.args]
    return spawn(command, args.local_ranks)


if __name__ == "__main__":
    sys.exit(main())
