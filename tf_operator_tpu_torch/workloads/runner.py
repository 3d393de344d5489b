"""Workload bootstrap: what a pod process does with the injected topology.

The counterpart of `tf_operator_tpu/workloads/runner.py`: parse TF_CONFIG +
the TPUJOB_* env into a WorkloadContext, pick the device, validate the
mesh (exit 2 when it does not fit), join the job's process group and lay
the one mesh over its ranks, hand the ranks that share a step's rows the
same batch, time the steps,
and capture a profiler trace for a window of steps.
One process drives one GPU, and the pod starts one for each of its GPUs
(`workloads/launch.py`): process i of pod p is global rank p x L + i of
pods x L, L the pod's local device count, the process-major order of
`jax.devices()` over which the JAX workloads lay their mesh.  The four
training workloads (lm, resnet, vit, bert) share these steps and start
through the launcher; the estimator reads TF_CONFIG as TF's RunConfig
does (`runconfig_from_env`).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from datetime import timedelta
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..api import constants


class ProfileCapture:
    """Profile a window of training steps with `torch.profiler` (host ops
    and, on the card, CUDA kernels) into a Chrome trace under
    `profile_dir`, between `start_step` and `start_step + num_steps`:
    `trace.json`, or `trace-local<i>.json` in local rank i of a pod's
    launcher, so the ranks of one pod do not write one file.
    No-op when profile_dir is falsy — workloads call `step(i)`
    unconditionally."""

    def __init__(self, profile_dir: Optional[str], start_step: int = 2,
                 num_steps: int = 3) -> None:
        # A non-positive window means "capture nothing", not "never stop".
        self.profile_dir = profile_dir if num_steps > 0 else None
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self._captured = False

    def step(self, i: int) -> None:
        if not self.profile_dir:
            return
        if i == self.start_step and self._prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        elif i == self.stop_step and self._prof is not None:
            self._stop()

    def close(self) -> None:
        if self._prof is not None:
            self._stop()
        elif self.profile_dir and not self._captured:
            # asked for a profile, never reached the window — say so rather
            # than exit 0 with an empty directory
            print(f"warning: profile window (start step {self.start_step}) "
                  f"was never reached; no trace written", flush=True)

    def _stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        local = os.environ.get(constants.ENV_LOCAL_RANK)
        self._prof.export_chrome_trace(os.path.join(
            self.profile_dir,
            "trace.json" if local is None else f"trace-local{local}.json"))
        self._prof = None
        self._captured = True
        print(f"profile trace written to {self.profile_dir}", flush=True)


def add_profile_args(parser) -> None:
    """The shared --profile-* CLI surface for training workloads."""
    parser.add_argument("--profile-dir", default=None,
                        help="capture a torch.profiler trace here")
    parser.add_argument("--profile-start", type=int, default=2)
    parser.add_argument("--profile-steps", type=int, default=3)


def apply_forced_platform(env: Optional[Dict[str, str]] = None):
    """The device the workload runs on: CUDA, unless TPUJOB_FORCE_PLATFORM
    asks for the CPU (hermetic tests); a process the pod launcher started
    takes `cuda:<its local rank>` and makes it current.  Raises
    RuntimeError when no CUDA device is present and the CPU was not asked
    for, or when the local rank has no GPU: the port never falls back to
    the CPU, or to fewer ranks than devices, on its own."""
    import torch

    env = os.environ if env is None else env
    forced = env.get(constants.ENV_FORCE_PLATFORM, "").lower()
    if forced == "cpu":
        return torch.device("cpu")
    if forced not in ("", "cuda", "gpu"):
        raise RuntimeError(
            f"{constants.ENV_FORCE_PLATFORM}={forced!r}: this runtime runs "
            "on 'cuda' (default) or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; set "
            f"{constants.ENV_FORCE_PLATFORM}=cpu to run on the CPU")
    local = env.get(constants.ENV_LOCAL_RANK)
    if local is None:
        return torch.device("cuda", torch.cuda.current_device())
    if int(local) >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local} has no GPU: {torch.cuda.device_count()} "
            "visible")
    device = torch.device("cuda", int(local))
    torch.cuda.set_device(device)
    return device


@dataclass
class WorkloadContext:
    replica_type: str = "worker"
    replica_index: int = 0
    tf_config: Optional[dict] = None
    coordinator_address: Optional[str] = None
    process_id: Optional[int] = None
    num_processes: int = 1
    mesh_shape: Dict[str, int] = field(default_factory=dict)
    accelerator: str = ""
    slice_topology: str = ""
    zero_shard_weight_update: bool = False
    # Elastic virtual-replica mapping: V fixed virtual replicas multiplexed
    # onto the current physical width.  0/0 means the group is not elastic.
    virtual_replicas: int = 0
    physical_replicas: int = 0
    elastic_generation: int = 0
    # set in the processes the pod launcher starts (workloads/launch.py):
    # this process's local rank, and L, the pod's local device count
    local_rank: Optional[int] = None
    local_count: int = 1

    @property
    def is_elastic(self) -> bool:
        return self.virtual_replicas > 0 and self.physical_replicas > 0

    def virtual_assignment(self) -> list:
        """The virtual replica ids THIS physical replica hosts:
        {j : j % P == replica_index}.  Empty for non-elastic contexts."""
        if not self.is_elastic:
            return []
        return [
            j for j in range(self.virtual_replicas)
            if j % self.physical_replicas == self.replica_index
        ]

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "WorkloadContext":
        env = dict(os.environ if env is None else env)
        tf_config = None
        raw = env.get(constants.ENV_TF_CONFIG)
        if raw:
            tf_config = json.loads(raw)
        mesh_raw = env.get(constants.ENV_MESH_SHAPE, "")
        pid = env.get(constants.ENV_PROCESS_ID)
        local = env.get(constants.ENV_LOCAL_RANK)
        ctx = cls(
            replica_type=env.get(constants.ENV_REPLICA_TYPE, "worker"),
            replica_index=int(env.get(constants.ENV_REPLICA_INDEX, "0")),
            tf_config=tf_config,
            coordinator_address=env.get(constants.ENV_COORDINATOR_ADDRESS),
            process_id=int(pid) if pid is not None else None,
            num_processes=int(env.get(constants.ENV_NUM_PROCESSES, "1")),
            mesh_shape=json.loads(mesh_raw) if mesh_raw else {},
            accelerator=env.get(constants.ENV_ACCELERATOR, ""),
            slice_topology=env.get(constants.ENV_SLICE_TOPOLOGY, ""),
            zero_shard_weight_update=env.get(
                constants.ENV_ZERO_SHARD_WEIGHT_UPDATE, ""
            ).lower() in ("1", "true"),
            virtual_replicas=int(
                env.get(constants.ENV_VIRTUAL_REPLICAS, "0") or 0
            ),
            physical_replicas=int(
                env.get(constants.ENV_PHYSICAL_REPLICAS, "0") or 0
            ),
            elastic_generation=int(
                env.get(constants.ENV_ELASTIC_GENERATION, "0") or 0
            ),
            local_rank=int(local) if local is not None else None,
            local_count=int(env.get(constants.ENV_LOCAL_WORLD_SIZE, "1")),
        )
        # TF_CONFIG task block wins when present (parity with the reference's
        # contract: the task identity is authoritative there).
        if tf_config and "task" in tf_config:
            ctx.replica_type = tf_config["task"].get("type", ctx.replica_type)
            ctx.replica_index = int(tf_config["task"].get("index", ctx.replica_index))
        return ctx

    @property
    def rank(self) -> int:
        """This process's global rank: TPUJOB_PROCESS_ID x L + its local
        rank, so rank r sits where JAX's device r does."""
        return (self.process_id or 0) * self.local_count + (
            self.local_rank or 0)

    @property
    def world(self) -> int:
        """The job's rank count: pods x L (the count of `jax.devices()`)."""
        return self.num_processes * self.local_count

    @property
    def multi_process(self) -> bool:
        """Whether this process joins a group: a pod of a multi-pod job
        (the JAX package initializes jax.distributed on the same
        condition), or any process the pod launcher started."""
        return self.local_rank is not None or (
            self.num_processes > 1 and self.process_id is not None)

    def initialize_distributed(self, device) -> bool:
        """Join the job's process group: global rank `rank` of `world`,
        its store at TPUJOB_COORDINATOR_ADDRESS (host:port, which global
        rank 0 serves); nccl on a CUDA device, which becomes this
        process's device first, gloo on the CPU.  The pods first check
        that they agree on L; a pod that does not exits 2 (SystemExit)
        once every process has read the counts, rather than wait in a
        rendezvous that cannot complete.  No-op for single-process jobs
        (returns whether it joined)."""
        if not self.multi_process:
            return False
        import torch
        import torch.distributed as dist

        if device.type == "cuda":
            torch.cuda.set_device(device)
        host, port = self.coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), is_master=self.rank == 0,
                              wait_for_workers=False,
                              timeout=timedelta(seconds=300))
        self._agree_on_local_count(store)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", store=store,
            world_size=self.world, rank=self.rank)
        return True

    def _agree_on_local_count(self, store) -> None:
        """Publish this pod's L in `store` and read every pod's; on a
        disagreement, print it once per pod and exit 2, global rank 0
        (the store's server) only after every process has read."""
        pod = self.process_id or 0
        if not self.local_rank:
            store.set(f"tpujob/local_count/{pod}", str(self.local_count))
        counts = [int(store.get(f"tpujob/local_count/{p}"))
                  for p in range(self.num_processes)]
        if all(n == self.local_count for n in counts):
            return
        store.add("tpujob/local_count/read", 1)
        if self.rank == 0:
            deadline = time.monotonic() + 60
            while (store.add("tpujob/local_count/read", 0) < sum(counts)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        pod_say(f"the pods disagree on their local device count: "
                f"{dict(enumerate(counts))} (pod: count); every pod must "
                "run as many processes as the others")
        raise SystemExit(2)

    def mesh_layout(self):
        """The mesh of TPUJOB_MESH_SHAPE over the job's ranks (all on dp
        when the shape is empty), as a layout: axis names, sizes and each
        rank's place, before any group is joined.  Raises ValueError when
        the axes do not multiply to the rank count."""
        from ..parallel.mesh import build_mesh

        import torch.distributed as dist

        world = (dist.get_world_size() if dist.is_initialized() else
                 self.world if self.multi_process else 1)
        return build_mesh(self.mesh_shape or None, world)


def runconfig_from_env(env: Optional[Dict[str, str]] = None) -> Dict[str, object]:
    """Parse TF_CONFIG exactly as TF's TFConfigClusterResolver + RunConfig
    would (a copy of the JAX package's `runconfig_from_env`), returning the
    same dict shape the reference's test-server dumps from the *real*
    RunConfig (test/test-server/test_app.py:35-44) and its E2E asserts per
    replica (estimator_runconfig_tests.py:26-102):

        task_type, task_id, cluster_spec, is_chief, master,
        num_worker_replicas, num_ps_replicas

    Semantics reproduced:
    - master = "grpc://<own cluster_spec entry>";
    - is_chief iff task is chief/master (or the job is non-distributed);
    - num_worker_replicas counts chief+master+worker ("chief is also a
      worker" — estimator_runconfig_tests.py:84);
    - the evaluator runs outside the cluster: empty cluster_spec, empty
      master, zero counts (estimator_runconfig_tests.py:88-96);
    - no TF_CONFIG (single-process): local-master defaults;
    - sparse variant (EnableDynamicWorker): the worker's view is itself +
      all PS (tensorflow.go:64-83), so master/counts derive from that.
    """
    env = dict(os.environ if env is None else env)
    raw = env.get(constants.ENV_TF_CONFIG)
    if not raw:
        # local mode: TF's RunConfig reports itself as the one worker
        return {
            "task_type": "worker", "task_id": 0, "cluster_spec": {},
            "is_chief": True, "master": "", "num_worker_replicas": 1,
            "num_ps_replicas": 0,
        }
    cfg = json.loads(raw)
    task = cfg.get("task", {})
    task_type = str(task.get("type", "worker"))
    task_id = int(task.get("index", 0))

    if task_type == "evaluator":
        return {
            "task_type": "evaluator", "task_id": task_id, "cluster_spec": {},
            "is_chief": False, "master": "", "num_worker_replicas": 0,
            "num_ps_replicas": 0,
        }

    if "sparseCluster" in cfg:
        # The sparse document carries only worker/ps views by design
        # (tensorflow.go:64-83 has exactly those two fields); a chief/master
        # in a dynamic-worker job keeps its role bit but has no address in
        # its own sparse view.
        sparse = cfg["sparseCluster"]
        workers = sparse.get("worker", {}) or {}
        ps = list(sparse.get("ps", []) or [])
        if task_type == "ps":
            own = ps[0] if ps else ""
        else:
            own = workers.get(str(task_id), "")
        return {
            "task_type": task_type, "task_id": task_id,
            "cluster_spec": {"worker": workers, "ps": ps},
            "is_chief": task_type in ("chief", "master"),
            "master": f"grpc://{own}" if own else "",
            "num_worker_replicas": len(workers),
            "num_ps_replicas": len(ps),
        }

    cluster = cfg.get("cluster", {})
    own_list = cluster.get(task_type, [])
    own = own_list[task_id] if task_id < len(own_list) else ""
    return {
        "task_type": task_type,
        "task_id": task_id,
        "cluster_spec": cluster,
        "is_chief": task_type in ("chief", "master"),
        "master": f"grpc://{own}" if own else "",
        "num_worker_replicas": (
            len(cluster.get("worker", []))
            + len(cluster.get("chief", []))
            + len(cluster.get("master", []))
        ),
        "num_ps_replicas": len(cluster.get("ps", [])),
    }


def plan_mesh(ctx: WorkloadContext) -> Tuple[Optional[object], int]:
    """(the mesh layout, 0), or (None, 2) after printing why a mesh does not
    fit the processes.  An axis that neither splits the batch nor shards
    the model (pp; for the classifiers ep; for ResNet tp and sp) replicates
    the step, as in the JAX workloads."""
    try:
        layout = ctx.mesh_layout()
    except ValueError as e:
        pod_say(f"invalid mesh: {e}")
        return None, 2
    return layout, 0


def split_batch(batch: int, layout, grad_accum: int = 1) -> Optional[str]:
    """Why `batch` rows do not split over the layout's data axes (dp,
    fsdp) into rows that grad_accum divides, or None when they do."""
    dp, fsdp = layout.shape.get("dp", 1), layout.shape.get("fsdp", 1)
    over = f"dp={dp}" + (f" x fsdp={fsdp}" if "fsdp" in layout.shape
                         else "")
    if batch % (dp * fsdp) or (batch // (dp * fsdp)) % grad_accum:
        tail = (f" into rows that --grad-accum {grad_accum} divides"
                if grad_accum > 1 else "")
        return f"--batch {batch} must split over {over}{tail}"
    return None


def same_batch_over_replicas(batches, sharding):
    """`batches` (this rank's rows, `train/step.shard_rows`, as dicts of
    tensors on the device), each broadcast over the ranks that hold the
    same rows, the ranks that differ only along axes larger than 1 other
    than the data axes, from the first of them, then cut to this rank's
    slice of the sequence (`train/step.shard_sequence`): ranks that
    replicate the step, or split one sequence over sp, must read one
    batch, and a loader whose threads hand batches over in no fixed order
    (the native image loader), or one seeded per replica, would give them
    different ones.  `batches` as it is without a mesh (`sharding`
    None)."""
    import torch.distributed as dist

    from ..parallel.mesh import data_axes
    from ..train.step import shard_sequence

    if sharding is None:
        return batches
    mesh = sharding.mesh
    axes = [a for a in mesh.axis_names
            if a not in data_axes(mesh) and mesh.shape[a] > 1]
    group = (mesh.group_over(axes) or dist.group.WORLD) if axes else None

    def broadcast():
        for batch in batches:
            if group is not None:
                src = dist.get_global_rank(group, 0)
                for t in batch.values():
                    dist.broadcast(t, src, group=group)
            yield shard_sequence(batch, sharding)

    return broadcast()


def zero_plan_for_workload(model, layout, enabled: bool):
    """The ZeRO weight-update sharding plan (train/zero.py) when `enabled`
    (the spec knob, injected as TPUJOB_ZERO_SHARD_WEIGHT_UPDATE, or the
    flag) and the layout has a dp axis larger than 1; else None.  Prints
    the plan as one `zero_sharding_plan: {...}` line, byte for byte the JAX
    workload's for the same model and mesh (the log line AMP tooling
    lifts), or that the dp axis of size 1 runs dense.  Shapes come from the
    model's flax map, so no weights are needed."""
    if not enabled:
        return None
    from ..train.zero import plan_for_model

    if layout.shape.get("dp", 1) <= 1:
        pod_say("zero-shard-weight-update: dp axis size is 1, running dense")
        return None
    plan = plan_for_model(model, layout)
    pod_say(f"zero_sharding_plan: {plan.to_json()}")
    return plan


def train_state_on_mesh(model, tx, device, mesh, layout, zero: bool):
    """The train state of `model` from seed 0 on `device`, laid out on
    `mesh` (over the process group, or None for one process), with the ZeRO
    plan when `zero` asks for it (its line printed once per pod, as each
    JAX process prints it); None after printing why a layout cannot hold
    the model (a caller exits 2)."""
    from ..train.state import create_train_state

    plan = zero_plan_for_workload(model, layout, zero)
    try:
        return create_train_state(model, tx, seed=0, device=device,
                                  mesh=mesh, zero_plan=plan)
    except ValueError as e:
        pod_say(f"invalid sharding: {e}")
        return None


@contextlib.contextmanager
def process_group(ctx: WorkloadContext, device, layout):
    """Join the job's group (a no-op for one process) and yield the layout
    laid over it, the one mesh of the run; None when no group is
    initialized.  A group this process joined is left on exit."""
    import torch.distributed as dist

    owned = ctx.initialize_distributed(device)
    try:
        yield layout.over_group(device.type) if dist.is_initialized() \
            else None
    finally:
        if owned:
            dist.destroy_process_group()


def print_line(line: str) -> None:
    """`line` and its newline in one write, flushed: the processes of a pod
    share its stdout, and unbuffered (PYTHONUNBUFFERED) `print` writes the
    newline apart, so another process's line could land between them."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def pod_say(line: str) -> None:
    """Print once per pod: in a process the pod launcher did not start,
    or on its local rank 0 (a line each pod's log holds once, as each JAX
    process prints it)."""
    if os.environ.get(constants.ENV_LOCAL_RANK, "0") == "0":
        print_line(line)


def say(line: str) -> None:
    """Print on rank 0 of the group (or without one)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        print_line(line)


class StepTimer:
    """The mean wall time of a run's steps after its first (which warms
    caches and the allocator), on the host clock, ending in a
    synchronize."""

    def __init__(self, device, first_step: int) -> None:
        self.device, self.first = device, first_step
        self._t0: Optional[float] = None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step_done(self, i: int) -> None:
        if i == self.first:
            self.sync()
            self._t0 = time.perf_counter()

    def line(self, last_step: int, items: int, unit: str) -> Optional[str]:
        """`step time {ms} ms over steps {a}-{b}, {rate} {unit}/s` for
        `items` per step (of the global batch), or None for a run of one
        step."""
        self.sync()
        timed = last_step - self.first
        if timed <= 0 or self._t0 is None:
            return None
        ms = (time.perf_counter() - self._t0) / timed * 1e3
        return (f"step time {ms:.3f} ms over steps {self.first + 1}-"
                f"{last_step}, {items / ms * 1e3:.1f} {unit}/s")


def run_steps(state, step, data, *, steps: int, device, log_every: int,
              profile: ProfileCapture, items: int, unit: str):
    """The classification workloads' loop: `steps` steps of `step` on
    `data`, `step {i} loss ...` every `log_every`, then the step time line;
    returns (the last loss, the loop's wall seconds).  Reads the loss only
    where it logs, so the host runs ahead of the device."""
    timer = StepTimer(device, 0)
    t_start = time.time()
    loss = None
    for i in range(steps):
        profile.step(i)
        state, metrics = step(state, next(data))
        loss = metrics["loss"]
        if i % log_every == 0:
            say(f"step {i} loss {float(loss):.4f}")
        timer.step_done(i)
    line = timer.line(steps - 1, items, unit)
    if line:
        say(line)
    profile.close()
    return (float("nan") if loss is None else float(loss),
            time.time() - t_start)
