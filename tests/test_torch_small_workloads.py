"""The port's small workloads as TPUJobs of the control plane, on the CPU.

BASELINE config 1 (single-worker MNIST), config 2 (2 PS + 4 workers on the
Python transport, 2 PS + 2 workers on the native one), config 5 (the
preemptible job: exit 143, gang restart, resume from the checkpoint), the
estimator's train-and-evaluate, smoke, allreduce_check over two gloo
processes and multislice_check over 4 workers on 2-host slices.  The
controller launches the pods as real processes (`LocalProcessCluster`);
only the container command names `tf_operator_tpu_torch`.
"""
import re
import sys
import time
from pathlib import Path

import pytest

from tf_operator_tpu.api.core import Container, ObjectMeta, PodTemplateSpec
from tf_operator_tpu.api.types import (CleanPodPolicy, ReplicaSpec,
                                       ReplicaType, RestartPolicy, RunPolicy,
                                       SuccessPolicy, TPUJob, TPUJobSpec,
                                       TPUTopology)
from tf_operator_tpu.controller.controller import TPUJobController
from tf_operator_tpu.runtime.local import LocalProcessCluster
from tf_operator_tpu.sdk.client import TPUJobClient

REPO = Path(__file__).resolve().parents[1]
STEP_TIME = re.compile(r"^step time \S+ ms over steps \S+, \S+ images/s$",
                       re.M)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    work = tmp_path_factory.mktemp("small-workloads")
    cluster = LocalProcessCluster(
        workdir=str(work / "work"),
        extra_env={"TPUJOB_FORCE_PLATFORM": "cpu", "PYTHONPATH": str(REPO),
                   "OMP_NUM_THREADS": "1"})
    controller = TPUJobController(cluster, threadiness=2,
                                  resolver=cluster.resolver)
    controller.start()
    try:
        yield cluster, TPUJobClient(cluster), work
    finally:
        controller.stop()
        cluster.close()


def container(workload, args=()):
    return PodTemplateSpec(containers=[Container(
        name="tensorflow", image="local",
        command=[sys.executable, "-m",
                 f"tf_operator_tpu_torch.workloads.{workload}"],
        args=list(args))])


def run_job(client, name, replica_specs, timeout=120, **spec):
    client.create(TPUJob(metadata=ObjectMeta(name=name),
                         spec=TPUJobSpec(replica_specs=replica_specs,
                                         **spec)))
    client.wait_for_job(name, timeout=timeout)
    logs = client.get_logs(name)
    assert client.is_job_succeeded(name), logs
    return logs


def logs_with(client, name, marker, count, timeout=30.0):
    """The job's logs once `count` of them hold `marker` (a pod's last line
    may still be flushing when the job turns Succeeded)."""
    deadline = time.time() + timeout
    while True:
        logs = client.get_logs(name)
        if (sum(marker in t for t in logs.values()) >= count
                or time.time() > deadline):
            return logs
        time.sleep(0.2)


def test_config1_single_worker_mnist(stack):
    _, client, _ = stack
    logs = run_job(client, "port-mnist", {ReplicaType.WORKER: ReplicaSpec(
        replicas=1, template=container(
            "mnist", ["--steps", "30", "--target-loss", "1.0"]))})
    text = "\n".join(logs.values())
    assert "mnist workload: role=worker index=0" in text
    m = re.search(r"^final loss (\S+)$", text, re.M)
    assert m and float(m.group(1)) < 1.0, text
    assert STEP_TIME.search(text), text


@pytest.mark.parametrize("transport,workers", [("python", 4), ("native", 2)])
def test_config2_parameter_server_dist_mnist(stack, transport, workers):
    """2 PS + N workers pulling and pushing over the TF_CONFIG addresses;
    worker 0's exit marks the job Succeeded and CleanPodPolicy reaps the
    serving PS pods."""
    cluster, client, _ = stack
    name = f"port-dist-mnist-{transport}"
    args = ["--steps", "20", "--transport", transport]
    run_job(client, name, {
        ReplicaType.PS: ReplicaSpec(replicas=2,
                                    template=container("dist_mnist", args)),
        ReplicaType.WORKER: ReplicaSpec(
            replicas=workers, template=container(
                "dist_mnist", args + ["--target-loss", "1.5"])),
    })
    text = logs_with(client, name, f"({transport} transport) final loss",
                     1)[f"{name}-worker-0"]
    m = re.search(rf"^worker 0 \({transport} transport\) final loss (\S+)$",
                  text, re.M)
    assert m and float(m.group(1)) < 1.5, text
    assert re.search(r"^worker 0 pull \S+ ms \+ push \S+ ms per step", text,
                     re.M), text
    deadline = time.time() + 30
    while time.time() < deadline and any(
            p.status.phase.value == "Running"
            for p in cluster.list_pods(selector={"job-name": name})):
        time.sleep(0.1)
    assert all(p.status.phase.value != "Running"
               for p in cluster.list_pods(selector={"job-name": name}))


def test_config5_preempt_resume(stack):
    """The first life checkpoints at step 5 and exits 143; RestartPolicy
    ExitCode recreates the pod, which resumes from step 5 and finishes."""
    _, client, work = stack
    logs = run_job(client, "port-preempt", {ReplicaType.WORKER: ReplicaSpec(
        replicas=1, restart_policy=RestartPolicy.EXIT_CODE,
        template=container("mnist", [
            "--steps", "12", "--batch", "16", "--checkpoint-dir",
            str(work / "preempt-ckpt"), "--preempt-at-step", "5"]))},
        timeout=180)
    text = "\n".join(logs.values())
    assert "resumed from checkpoint step 5" in text
    assert "final loss" in text
    reasons = [e.reason for e in client.get_events("port-preempt")]
    assert "ExitedWithCode" in reasons and "SuccessfulDeletePod" in reasons
    assert reasons.count("SuccessfulCreatePod") >= 2


def test_estimator_train_and_evaluate(stack):
    _, client, work = stack
    model_dir = work / "estimator-model"
    args = ["--steps", "30", "--checkpoint-every", "10", "--model-dir",
            str(model_dir)]
    run_job(client, "port-estimator", {
        rtype: ReplicaSpec(replicas=1, template=container("estimator", args))
        for rtype in (ReplicaType.CHIEF, ReplicaType.PS, ReplicaType.WORKER,
                      ReplicaType.EVALUATOR)
    }, run_policy=RunPolicy(clean_pod_policy=CleanPodPolicy.NONE))
    assert (model_dir / "DONE").exists()
    assert sorted(p.name for p in model_dir.glob("ckpt-*.npz")) == [
        "ckpt-10.npz", "ckpt-20.npz", "ckpt-30.npz"]
    eval_log = logs_with(client, "port-estimator", "evaluator done",
                         1)["port-estimator-evaluator-0"]
    assert "eval step=" in eval_log and "evaluator done" in eval_log, \
        eval_log
    chief = client.get_logs("port-estimator")["port-estimator-chief-0"]
    assert "chief: published DONE" in chief


def test_smoke_job(stack):
    """Two workers join one gloo group and check the matmul; the PS
    replica parks at once.  The workers can finish before the PS process
    has started, and the default CleanPodPolicy (Running) would then
    delete the PS pod and its log, so this job keeps its pods."""
    _, client, _ = stack
    logs = run_job(client, "port-smoke", {
        ReplicaType.PS: ReplicaSpec(replicas=1, template=container("smoke")),
        ReplicaType.WORKER: ReplicaSpec(
            replicas=2, template=container("smoke", ["--size", "128"])),
    }, success_policy=SuccessPolicy.ALL_WORKERS,
        run_policy=RunPolicy(clean_pod_policy=CleanPodPolicy.NONE))
    logs = logs_with(client, "port-smoke", "checksum=", 2)
    assert sum("checksum=2.097e+06 expected=2.097e+06" in t
               for t in logs.values()) == 2, logs
    logs = logs_with(client, "port-smoke", "smoke PS parked OK", 1)
    assert "smoke PS parked OK" in logs["port-smoke-ps-0"], logs


def test_allreduce_check_over_two_gloo_processes(stack):
    _, client, _ = stack
    run_job(client, "port-allreduce", {ReplicaType.WORKER: ReplicaSpec(
        replicas=2, template=container("allreduce_check"))},
        success_policy=SuccessPolicy.ALL_WORKERS)
    logs = logs_with(client, "port-allreduce", "allreduce_check OK", 2)
    assert sum("allreduce_check OK" in t for t in logs.values()) == 2, logs
    assert all("allgather ranks=[[1], [2]] sum=3 expected=3" in t
               for t in logs.values()), logs


def test_multislice_check_four_workers_on_two_host_slices(stack):
    """v5litepod-8 in 2x4 is 8 chips over 2 hosts: 4 workers span 2
    slices, and every process checks the MEGASCALE layout over the live
    group."""
    _, client, _ = stack
    run_job(client, "port-mslice", {ReplicaType.WORKER: ReplicaSpec(
        replicas=4, tpu=TPUTopology(accelerator="v5litepod-8",
                                    topology="2x4"),
        template=container("multislice_check"))},
        success_policy=SuccessPolicy.ALL_WORKERS)
    logs = logs_with(client, "port-mslice", "multislice_check OK", 4)
    assert sum("multislice_check OK" in t for t in logs.values()) == 4, logs
    assert all("fabric table: [[0, 0], [1, 0], [2, 1], [3, 1]]" in t
               for t in logs.values()), logs
