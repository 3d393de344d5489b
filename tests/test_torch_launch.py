"""The port's per-pod launcher (`tf_operator_tpu_torch/workloads/launch.py`)
on the CPU: a pod with L local devices runs L processes over gloo, L from
TPUJOB_CPU_DEVICE_COUNT under TPUJOB_FORCE_PLATFORM=cpu.

- The layouts agree: the LM's final checkpoint after 4 AdamW steps under
  {"dp": 2, "tp": 2} (d_model 64, and 128 so that the heads split) is
  equal bit for bit whether the 4 ranks run as 2 pods x 2 local ranks,
  4 pods x 1 (one process per pod, in the pod's process) or 1 pod x 4;
  so are ResNet-18's losses and parameters under {"dp": 4} after each
  step, its BatchNorm statistics summed over pods and local ranks.
- The rank order agrees with JAX: global rank p x L + i has the mesh
  coordinates of `jax.devices()[p x L + i]` in the JAX package's
  `build_mesh` for five meshes and every split of their ranks into pods.
- The exit contract: the first failing child's code (2, or 137 for a
  SIGKILL, also when a sibling exits 1 the moment that child dies) with
  its siblings stopped; 143 for SIGTERM to the parent alone
  and for a `killpg` of the pod, with no child left; 2 when the pods
  disagree on L or the mesh does not fit pods x L.
- The LM's sampling guard counts ranks: one pod x 2 ranks skips sampling.
- A job the controller admits: a 2-worker TPUJob on a 2x4 topology with
  the mesh {"dp": 2, "fsdp": 2, "tp": 2} runs as 2 pods x 4 ranks on
  `LocalProcessCluster`; SIGTERM to each pod's pid after the first
  checkpoint exits 143, the gang restarts, resumes from the checkpoint
  and succeeds, and no process of the first life remains.

Each test starts one world of pods at a time (the layout tests the three
layouts at once), every process with OMP_NUM_THREADS=1, and waits by
polling for files, never by sleeping a fixed time.
"""
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tf_operator_tpu.parallel.mesh import build_mesh as j_build_mesh
from tf_operator_tpu_torch.parallel.mesh import build_mesh
from tf_operator_tpu_torch.workloads.runner import WorkloadContext
from torch_dist_worker import REPLICA_LINE

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_dist_worker.py")
LM = [sys.executable, "-m", "tf_operator_tpu_torch.workloads.lm"]
LAUNCH = [sys.executable, "-m", "tf_operator_tpu_torch.workloads.launch"]
TINY_LM = ["--seq-len", "16", "--vocab", "64", "--layers", "1", "--batch",
           "8"]
TIMEOUT = 120.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(what, check, timeout: float = TIMEOUT):
    """check()'s first truthy value, polled every 20 ms; fails the test
    after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        value = check()
        if value:
            return value
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.02)


def alive(pid: int) -> bool:
    """Whether `pid` runs: it exists and is not a zombie (a pod's parent
    stays one until the cluster that started it reaps it)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


class Pods:
    """`pods` pod processes of one job, each its own process group with
    L local devices (TPUJOB_CPU_DEVICE_COUNT), each writing its log to a
    file; every one still running is killed on exit."""

    def __init__(self, tmp: Path, command, pods: int, local: int,
                 env=None, coordinator: bool = True) -> None:
        self.logs = [tmp / f"pod-{p}.log" for p in range(pods)]
        base = {**os.environ, "PYTHONPATH": str(REPO),
                "OMP_NUM_THREADS": "1", "TPUJOB_FORCE_PLATFORM": "cpu",
                "TPUJOB_NUM_PROCESSES": str(pods), **(env or {})}
        if coordinator:
            base["TPUJOB_COORDINATOR_ADDRESS"] = f"127.0.0.1:{free_port()}"
        self.procs = []
        for p in range(pods):
            with open(self.logs[p], "wb") as log:
                self.procs.append(subprocess.Popen(
                    command, cwd=str(REPO), stdout=log,
                    stderr=subprocess.STDOUT, start_new_session=True,
                    env={**base, "TPUJOB_PROCESS_ID": str(p),
                         "TPUJOB_CPU_DEVICE_COUNT":
                             str(local[p] if isinstance(local, list)
                                 else local)}))

    def wait(self) -> list:
        """Every pod's exit code once all have exited."""
        try:
            return [proc.wait(timeout=TIMEOUT) for proc in self.procs]
        finally:
            self.close()

    def text(self, p: int = 0) -> str:
        return self.logs[p].read_text(errors="replace")

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def final_state(directory: Path, step: int) -> dict:
    return torch.load(directory / str(step) / "state.pt",
                      map_location="cpu", weights_only=True)


def flat(tree, prefix=""):
    """{path: tensor} of a nested dict of tensors (a saved state)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: torch.tensor(tree)}


LAYOUTS = [(2, 2), (4, 1), (1, 4)]


@pytest.mark.parametrize("d_model", [64, 128])
def test_lm_checkpoint_equal_bit_for_bit_across_pod_layouts(tmp_path,
                                                           d_model):
    """The LM under {"dp": 2, "tp": 2}, 4 AdamW steps: the final
    checkpoint of 2 pods x 2 local ranks equals, tensor by tensor and bit
    for bit, that of 4 pods x 1 and of 1 pod x 4 (the one-pod job with no
    coordinator: the launcher picks the store's port)."""
    runs = {}
    for pods, local in LAYOUTS:
        tag = f"{pods}x{local}"
        (tmp_path / tag).mkdir()
        runs[tag] = Pods(
            tmp_path / tag, LM + TINY_LM + [
                "--steps", "4", "--d-model", str(d_model),
                "--checkpoint-dir", str(tmp_path / tag / "ckpt"),
                "--checkpoint-every", "2"],
            pods, local, {"TPUJOB_MESH_SHAPE": '{"dp":2,"tp":2}'},
            coordinator=pods > 1)
    for tag, run in runs.items():
        assert run.wait() == [0] * len(run.procs), run.text()
    assert "pod launcher: 2 pod(s) x 2 local rank(s), world 4; pod 1 runs " \
        "global ranks 2-3" in runs["2x2"].text(1)
    assert "pod launcher" not in runs["4x1"].text()
    states = {tag: flat(final_state(tmp_path / tag / "ckpt", 4))
              for tag in runs}
    ref = states["4x1"]
    assert len(ref) > 10
    for tag in ("2x2", "1x4"):
        assert states[tag].keys() == ref.keys()
        differ = [k for k in ref if not torch.equal(states[tag][k], ref[k])]
        assert not differ, f"{tag} differs from 4x1 in {differ}"
    # each pod's log reads as one process's: its role line once, the
    # training lines on global rank 0's pod alone
    text = runs["2x2"].text(0)
    assert text.count("lm workload: role=worker") == 1
    assert text.count("step 0 loss") == 1 and text.count("\ndone") == 1
    assert "step 0 loss" not in runs["2x2"].text(1)


def rank0_steps(log: str) -> list:
    return [rest for rank, *rest in REPLICA_LINE.findall(log) if rank == "0"]


def test_resnet_steps_equal_bit_for_bit_across_pod_layouts(tmp_path):
    """ResNet-18 under {"dp": 4} (SGD, BatchNorm's batch statistics over
    the 4 ranks), 2 steps on the Python image stream: global rank 0's loss
    and the digest of its parameters after each step are the same for
    2 pods x 2, 4 pods x 1 and 1 pod x 4."""
    runs = {}
    for pods, local in LAYOUTS:
        tag = f"{pods}x{local}"
        (tmp_path / tag).mkdir()
        runs[tag] = Pods(
            tmp_path / tag, [sys.executable, WORKER, "workload", "resnet",
                             "0", "--depth", "18", "--batch", "8",
                             "--image-size", "32", "--num-classes", "10",
                             "--steps", "2", "--log-every", "1"],
            pods, local, {"TPUJOB_MESH_SHAPE": '{"dp":4}'})
    steps = {}
    for tag, run in runs.items():
        assert run.wait() == [0] * len(run.procs), run.text()
        steps[tag] = rank0_steps(run.text())
    assert len(steps["4x1"]) == 2
    assert steps["2x2"] == steps["4x1"] == steps["1x4"]


MESHES = [{"dp": 4}, {"dp": 2, "tp": 2}, {"fsdp": 2, "tp": 2},
          {"dp": 2, "sp": 2}, {"dp": 2, "fsdp": 2, "tp": 2}]


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: json.dumps(a))
def test_rank_order_matches_jax_devices(axes):
    """Global rank TPUJOB_PROCESS_ID x L + LOCAL_RANK, read from the env a
    pod's process gets, has the mesh coordinates of jax.devices()[rank]
    in the JAX package's mesh, for every split of the ranks into pods."""
    n = int(np.prod(list(axes.values())))
    devices = jax.devices()[:n]
    jmesh = j_build_mesh(axes, devices)
    want = {}
    for r, device in enumerate(devices):
        index = np.argwhere(jmesh.devices == device)[0]
        want[r] = dict(zip(jmesh.axis_names, (int(i) for i in index)))
    mesh = build_mesh(axes, n)
    for local in (1, 2, 4, 8):
        if n % local:
            continue
        ranks = []
        for pod in range(n // local):
            for i in range(local):
                ctx = WorkloadContext.from_env({
                    "TPUJOB_PROCESS_ID": str(pod),
                    "TPUJOB_NUM_PROCESSES": str(n // local),
                    "LOCAL_RANK": str(i), "LOCAL_WORLD_SIZE": str(local)})
                assert ctx.world == n and ctx.multi_process
                ranks.append(ctx.rank)
                got = {a: mesh.coordinate(a, ctx.rank)
                       for a in mesh.axis_names}
                assert got == want[ctx.rank], (pod, i, local)
        assert sorted(ranks) == list(range(n))


STANDIN_CASES = {
    # actions per local rank, who signals what, the pod's exit code
    "child_exits_2": (["sleep", "exit:2"], None, 2),
    "child_sigkilled": (["sleep", "kill:9"], None, 137),
    # local rank 0 exits 1 the moment rank 1 is SIGKILLed: the death, not
    # the follow-on failure, decides the pod's code
    "sibling_fails_after_a_sigkill": (["follow:1", "kill:9"], None, 137),
    "sigterm_to_parent": (["sleep", "sleep"], "parent", 143),
    "killpg_of_the_pod": (["sleep", "sleep"], "group", 143),
}


@pytest.mark.parametrize("case", list(STANDIN_CASES))
def test_exit_contract(tmp_path, case):
    """A stand-in child under the launcher's explicit entry (2 local
    ranks): the pod's exit code, and every child gone when it exits."""
    actions, signal_to, code = STANDIN_CASES[case]
    pod = Pods(tmp_path, LAUNCH + ["--local-ranks", "2", WORKER, "standin",
                                   str(tmp_path), *actions], 1, 1,
               coordinator=False)
    pids = wait_for("both children's pid files", lambda: [
        int((tmp_path / f"pid-{i}").read_text()) for i in range(2)]
        if all((tmp_path / f"pid-{i}").exists() for i in range(2)) else None)
    if signal_to == "parent":
        os.kill(pod.procs[0].pid, signal.SIGTERM)
    elif signal_to == "group":
        os.killpg(pod.procs[0].pid, signal.SIGTERM)
    assert pod.wait() == [code], pod.text()
    assert f"pod launcher: exit {code}" in pod.text()
    assert not [pid for pid in pids if alive(pid)]


def test_pods_that_disagree_on_l_exit_2(tmp_path):
    """Pod 0 with one local device (the workload in its process) and pod
    1 with two: both exit 2 and say why, rather than wait in the store's
    rendezvous."""
    pods = Pods(tmp_path, LM + TINY_LM + ["--steps", "2", "--d-model", "64"],
                2, [1, 2])
    assert pods.wait() == [2, 2], pods.text(0) + pods.text(1)
    for p in range(2):
        assert "the pods disagree on their local device count: " \
            "{0: 1, 1: 2}" in pods.text(p)


def test_mesh_that_does_not_fit_pods_times_l_exits_2(tmp_path):
    """{"dp": 4} on 1 pod x 2 local ranks: the parent prints JAX's message
    once and starts no child."""
    pods = Pods(tmp_path, LM + TINY_LM + ["--steps", "2"], 1, 2,
                {"TPUJOB_MESH_SHAPE": '{"dp":4}'}, coordinator=False)
    assert pods.wait() == [2]
    text = pods.text()
    assert text.count("invalid mesh: mesh axes {'dp': 4} require 4 "
                      "devices, but 2 are available") == 1, text
    assert "local rank pids" not in text


def test_sampling_is_skipped_over_local_ranks(tmp_path):
    """lm.py --sample-tokens on one pod x 2 local ranks: two ranks would
    sample alike, so the run skips it, as on several pods."""
    pods = Pods(tmp_path, LM + TINY_LM + ["--steps", "2", "--d-model", "64",
                                          "--sample-tokens", "4"], 1, 2,
                coordinator=False)
    assert pods.wait() == [0], pods.text()
    text = pods.text()
    assert text.count("sampling skipped on multi-host runs") == 1
    assert "sample: [" not in text and text.count("\ndone") == 1


def test_two_pod_tpujob_on_2x4_preempted_and_resumed(tmp_path):
    """The controller admits a 2-worker TPUJob on a 2x4 topology (8 chips)
    with the mesh {"dp": 2, "fsdp": 2, "tp": 2}; with L = 4 its pods run
    the LM as 8 gloo ranks.  SIGTERM to each pod's pid (not its group)
    after the first checkpoint: both pods exit 143, RestartPolicy ExitCode
    restarts the gang, which resumes from the checkpoint's step and
    succeeds (every worker exits 0) with the loss falling; no process of
    the first life remains."""
    from tf_operator_tpu.api.core import (Container, ObjectMeta,
                                          PodTemplateSpec)
    from tf_operator_tpu.api.types import (ReplicaSpec, ReplicaType,
                                           RestartPolicy, SuccessPolicy,
                                           TPUJob, TPUJobSpec, TPUTopology)
    from tf_operator_tpu.controller.controller import TPUJobController
    from tf_operator_tpu.runtime.local import LocalProcessCluster
    from tf_operator_tpu.sdk.client import TPUJobClient

    ckpt = tmp_path / "ckpt"
    cluster = LocalProcessCluster(
        workdir=str(tmp_path / "work"),
        extra_env={"TPUJOB_FORCE_PLATFORM": "cpu",
                   "TPUJOB_CPU_DEVICE_COUNT": "4", "PYTHONPATH": str(REPO),
                   "OMP_NUM_THREADS": "1"})
    controller = TPUJobController(cluster, threadiness=2,
                                  resolver=cluster.resolver)
    controller.start()
    try:
        client = TPUJobClient(cluster)
        client.create(TPUJob(
            metadata=ObjectMeta(name="port-pod-lm"),
            spec=TPUJobSpec(replica_specs={ReplicaType.WORKER: ReplicaSpec(
                replicas=2, restart_policy=RestartPolicy.EXIT_CODE,
                tpu=TPUTopology(topology="2x4",
                                mesh={"dp": 2, "fsdp": 2, "tp": 2}),
                template=PodTemplateSpec(containers=[Container(
                    name="tensorflow", image="local", command=LM,
                    args=TINY_LM + ["--steps", "40", "--d-model", "128",
                                    "--checkpoint-dir", str(ckpt),
                                    "--checkpoint-every", "4"])]))},
                success_policy=SuccessPolicy.ALL_WORKERS)))

        def pod_pids():
            pods = cluster.list_pods(selector={"job-name": "port-pod-lm"})
            pids = [p.metadata.annotations.get("local.tpu-operator.dev/pid")
                    for p in pods]
            return [int(x) for x in pids] if len(pids) == 2 and all(
                pids) else None

        parents = wait_for("the first life's pods", pod_pids)
        wait_for("the first checkpoint", lambda: (ckpt / "4").exists())
        for pid in parents:
            os.kill(pid, signal.SIGTERM)
        wait_for("the first life's exit",
                 lambda: not any(alive(pid) for pid in parents))
        saved = max(int(d.name) for d in ckpt.iterdir() if d.name.isdigit())
        client.wait_for_job("port-pod-lm", timeout=180)
        logs = client.get_logs("port-pod-lm")
        text = "\n".join(logs.values())
        assert client.is_job_succeeded("port-pod-lm"), text
    finally:
        controller.stop()
        cluster.close()
    assert text.count("pod launcher: exit 143") == 2, text
    assert text.count("pod launcher: exit 0") == 2, text
    assert text.count("pod launcher: 2 pod(s) x 4 local rank(s), world 8")\
        == 4
    assert f"resumed from step {saved}" in text
    assert text.count("\ndone") == 1
    losses = [float(x) for x in re.findall(r"^step \d+ loss (\S+)$", text,
                                           re.M)]
    assert len(losses) >= 2 and losses[-1] < losses[0]
    first_life = list(parents)
    for log in logs.values():
        lives = re.findall(r"local rank pids \[([\d, ]+)\]", log)
        assert len(lives) == 2, log
        first_life += [int(pid) for pid in lives[0].split(",")]
    assert len(first_life) == 10
    assert not [pid for pid in first_life if alive(pid)]
