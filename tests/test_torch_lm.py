"""The PyTorch port's LM workload (`python -m tf_operator_tpu_torch.workloads.lm`)
run as a pod would run it, on the CPU at a tiny size, and the port's import
hygiene: the port never imports JAX or the JAX package.
"""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tf_operator_tpu.workloads.runner import WorkloadContext as JaxContext
from tf_operator_tpu_torch.workloads import lm
from tf_operator_tpu_torch.workloads.runner import (
    ProfileCapture,
    WorkloadContext,
    apply_forced_platform,
)
from torch_dist_worker import launch_workload, replica_steps

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--batch", "4", "--seq-len", "16", "--vocab", "64", "--layers", "1",
        "--d-model", "64"]
TOPOLOGY_ENV = ("TPUJOB_MESH_SHAPE", "TPUJOB_NUM_PROCESSES",
                "TPUJOB_PROCESS_ID", "TPUJOB_ZERO_SHARD_WEIGHT_UPDATE",
                "TPUJOB_VIRTUAL_REPLICAS", "TPUJOB_PHYSICAL_REPLICAS",
                "TF_CONFIG")


def run_module(args, env_extra=None, force_cpu=True, timeout=120):
    env = {k: v for k, v in os.environ.items() if k not in TOPOLOGY_ENV}
    env.pop("TPUJOB_FORCE_PLATFORM", None)
    if force_cpu:
        env["TPUJOB_FORCE_PLATFORM"] = "cpu"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "tf_operator_tpu_torch.workloads.lm", *args],
        cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=timeout)


def losses(log):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step (\d+) loss (\S+)$", log, re.M)}


@pytest.fixture
def clean_env(monkeypatch):
    for name in TOPOLOGY_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUJOB_FORCE_PLATFORM", "cpu")
    return monkeypatch


def test_trains_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = run_module(["--steps", "11", "--checkpoint-dir", ckpt,
                        "--checkpoint-every", "5", "--lr", "3e-3"] + TINY)
    assert first.returncode == 0, first.stdout + first.stderr
    log = first.stdout
    assert "done" in log and "resumed" not in log
    got = losses(log)
    assert set(got) == {0, 10} and got[10] < got[0]
    assert sorted(int(p.name) for p in Path(ckpt).iterdir()) == [5, 10, 11]

    second = run_module(["--steps", "21", "--checkpoint-dir", ckpt,
                         "--checkpoint-every", "5", "--lr", "3e-3",
                         "--arch", "gpt"] + TINY)
    assert second.returncode == 0, second.stdout + second.stderr
    assert "resumed from step 11" in second.stdout
    assert "done" in second.stdout
    assert losses(second.stdout)[20] < got[10]
    # max_to_keep=3: the newest three steps remain
    assert sorted(int(p.name) for p in Path(ckpt).iterdir()) == [15, 20, 21]


def test_reports_its_step_time(clean_env, capsys):
    """One line with the mean time of the steps after the run's first, in
    the form chip_smoke.py reads."""
    from chip_smoke import STEP_TIME

    assert lm.main(["--steps", "4"] + TINY) == 0
    m = STEP_TIME.search(capsys.readouterr().out)
    assert m is not None and float(m.group(1)) > 0
    assert m.group(0).split(" over steps ")[1].startswith("1-3,")


def test_llama_options_run(clean_env, capsys):
    """llama/GQA with window + sink, chunked loss, remat and gradient
    accumulation: the options this package ports all run."""
    rc = lm.main(["--arch", "llama", "--steps", "2", "--d-model", "128",
                  "--attn-window", "8", "--attn-sink", "2", "--loss-chunk",
                  "8", "--remat", "--grad-accum", "2", "--rope-scaling",
                  "linear", "--rope-factor", "2"] + TINY[:-2])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "done" in out and "step 0 loss" in out


# a process of a multi-process job: the checks below run before it joins
# the group, so no peer is needed
PROCESS_0_OF = {"TPUJOB_PROCESS_ID": "0",
                "TPUJOB_COORDINATOR_ADDRESS": "127.0.0.1:1"}


def _multi(n, mesh):
    return {**PROCESS_0_OF, "TPUJOB_NUM_PROCESSES": str(n),
            "TPUJOB_MESH_SHAPE": json.dumps(mesh)}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("args", [[], ["--moe-experts", "2"]],
                         ids=["dense", "moe"])
def test_pp_axis_replicates_the_step(args):
    """The JAX workload builds no pipeline, so its ranks along pp run the
    same step: two ranks over {"pp": 2} log the one-process run's losses
    (printed to 4 decimals) from rank 0 alone, and every rank takes the
    same batch, computes the same loss and holds the same parameters after
    each step (the worker's workload mode prints each rank's)."""
    argv = ["--steps", "11"] + args + TINY
    env = {k: v for k, v in os.environ.items() if k not in TOPOLOGY_ENV}
    env.update(TPUJOB_FORCE_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO), TPUJOB_NUM_PROCESSES="2",
               TPUJOB_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               TPUJOB_MESH_SHAPE=json.dumps({"pp": 2}))
    procs = [launch_workload("lm", argv, dict(
        env, TPUJOB_PROCESS_ID=str(rank), TPUJOB_REPLICA_INDEX=str(rank)))
        for rank in range(2)]
    try:
        single = run_module(argv)
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert single.returncode == 0, single.stdout + single.stderr
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    want = re.findall(r"^step (\d+) loss (\S+)$", single.stdout, re.M)
    assert [i for i, _ in want] == ["0", "10"]
    assert re.findall(r"^step (\d+) loss (\S+)$", logs[0], re.M) == want
    assert logs[0].count("done") == 1 and "done" not in logs[1]
    steps = [replica_steps(log) for log in logs]
    assert [s[0] for s in steps[0]] == [str(i) for i in range(11)]
    assert steps[1] == steps[0]


@pytest.mark.parametrize("env,message", [
    ({"TPUJOB_MESH_SHAPE": json.dumps({"dp": 2})},
     "mesh axes {'dp': 2} require 2 devices, but 1 are available"),
    ({"TPUJOB_MESH_SHAPE": json.dumps({"tp": 2, "dp": 1})},
     "mesh axes {'dp': 1, 'tp': 2} require 2 devices, but 1 are available"),
    ({"TPUJOB_MESH_SHAPE": json.dumps({"sp": 4})},
     "mesh axes {'sp': 4} require 4 devices, but 1 are available"),
    # without a process id the job makes no group, as in the JAX package
    ({"TPUJOB_NUM_PROCESSES": "2",
      "TPUJOB_MESH_SHAPE": json.dumps({"dp": 2})},
     "mesh axes {'dp': 2} require 2 devices, but 1 are available"),
    (_multi(2, {"dp": 4}),
     "mesh axes {'dp': 4} require 4 devices, but 2 are available"),
])
def test_mesh_that_does_not_fit_the_processes_exits_2(clean_env, capsys,
                                                       env, message):
    """The mesh's product must equal the job's process count: otherwise
    exit 2 with build_mesh's message, before any group is joined."""
    for name, value in env.items():
        clean_env.setenv(name, value)
    rc = lm.main(["--steps", "1"] + TINY)
    out = capsys.readouterr().out
    assert rc == 2
    assert f"invalid mesh: {message}" in out


@pytest.mark.parametrize("args,env,message", [
    (["--batch", "6"], _multi(4, {"dp": 4}), "--batch 6 must split over "
                                             "dp=4"),
    (["--grad-accum", "4"], _multi(2, {"dp": 2}), "--grad-accum 4 divides"),
    (["--batch", "6"], _multi(4, {"dp": 2, "fsdp": 2}),
     "--batch 6 must split over dp=2 x fsdp=2"),
    (["--arch", "llama", "--d-model", "768", "--kv-heads", "3"],
     _multi(2, {"tp": 2}), "--kv-heads 3 must be divisible by tp=2"),
    (["--seq-len", "18"], _multi(4, {"sp": 4}), "--seq-len 18 must divide "
                                                "by sp=4"),
    (["--seq-parallel", "ulysses", "--d-model", "128"], _multi(4, {"sp": 4}),
     "seq_parallel='ulysses' needs num_heads (2)"),
])
def test_batch_or_model_that_does_not_shard_exits_2(clean_env, capsys, args,
                                                    env, message):
    for name, value in env.items():
        clean_env.setenv(name, value)
    rc = lm.main(["--steps", "1"] + TINY + args)
    out = capsys.readouterr().out
    assert rc == 2
    assert message in out


@pytest.mark.parametrize("args,message", [
    (["--grad-accum", "3"], "--grad-accum 3 must be"),
    (["--sample-tokens", "20"], "needs prompt"),
    (["--rope-scaling", "ntk"], "requires --arch llama"),
    (["--arch", "llama", "--kv-heads", "3"], "--kv-heads 3 must divide"),
    (["--arch", "llama", "--kv-heads", "-1"], "must be positive"),
    (["--attn-sink", "4"], "invalid model config"),
    (["--lr-schedule", "cosine", "--warmup-steps", "5", "--steps", "3"],
     "invalid optimizer config"),
])
def test_bad_input_exits_2_like_the_jax_workload(clean_env, capsys, args,
                                                 message):
    rc = lm.main(TINY + ["--steps", "1"] + args)
    assert rc == 2
    assert message in capsys.readouterr().out


def test_zero_knob_on_dense_mesh_runs_dense(clean_env, capsys):
    clean_env.setenv("TPUJOB_ZERO_SHARD_WEIGHT_UPDATE", "1")
    assert lm.main(["--steps", "1"] + TINY) == 0
    out = capsys.readouterr().out
    assert "dp axis size is 1, running dense" in out and "done" in out


def test_exits_nonzero_without_cuda_or_cpu_knob():
    """No CUDA device and no TPUJOB_FORCE_PLATFORM: a clear message and a
    non-zero exit, never a quiet CPU run."""
    proc = run_module(["--steps", "1"] + TINY, force_cpu=False,
                      env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "TPUJOB_FORCE_PLATFORM=cpu" in proc.stdout
    assert "step 0" not in proc.stdout


def test_apply_forced_platform():
    assert apply_forced_platform({"TPUJOB_FORCE_PLATFORM": "cpu"}).type == "cpu"
    with pytest.raises(RuntimeError, match="'cuda' \\(default\\) or 'cpu'"):
        apply_forced_platform({"TPUJOB_FORCE_PLATFORM": "tpu"})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            apply_forced_platform({})


@pytest.mark.parametrize("env", [
    {},
    {"TPUJOB_REPLICA_TYPE": "chief", "TPUJOB_REPLICA_INDEX": "0",
     "TPUJOB_PROCESS_ID": "3", "TPUJOB_NUM_PROCESSES": "4",
     "TPUJOB_COORDINATOR_ADDRESS": "host:1234",
     "TPUJOB_MESH_SHAPE": '{"dp": 2, "tp": 2}',
     "TPUJOB_ZERO_SHARD_WEIGHT_UPDATE": "true",
     "TPUJOB_ACCELERATOR": "v5litepod-8", "TPUJOB_SLICE_TOPOLOGY": "2x4"},
    {"TF_CONFIG": json.dumps({"cluster": {"worker": ["a:1", "b:2"]},
                              "task": {"type": "worker", "index": 1}}),
     "TPUJOB_REPLICA_TYPE": "ps", "TPUJOB_REPLICA_INDEX": "0",
     "TPUJOB_VIRTUAL_REPLICAS": "5", "TPUJOB_PHYSICAL_REPLICAS": "2",
     "TPUJOB_ELASTIC_GENERATION": "3"},
])
def test_workload_context_matches_jax(env):
    ours, theirs = WorkloadContext.from_env(env), JaxContext.from_env(env)
    assert vars(ours) == vars(theirs)
    assert ours.is_elastic == theirs.is_elastic
    assert ours.virtual_assignment() == theirs.virtual_assignment()


def test_profile_capture_writes_a_trace(tmp_path, capsys):
    prof = ProfileCapture(str(tmp_path / "prof"), start_step=1, num_steps=1)
    for i in range(3):
        prof.step(i)
        torch.ones(8).sum()
    prof.close()
    assert (tmp_path / "prof" / "trace.json").exists()
    assert "profile trace written" in capsys.readouterr().out
    never = ProfileCapture(str(tmp_path / "never"), start_step=5)
    never.step(0)
    never.close()
    assert "never reached" in capsys.readouterr().out


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tf_operator_tpu")


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without pulling
    in jax/flax/optax/orbax or anything of tf_operator_tpu, and no
    `import` or `from` statement in their files names them."""
    code = """
import importlib, pkgutil, sys
import tf_operator_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "tf_operator_tpu"))
print(len(names), bad)
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # every module, the parallel package's four among them
    assert int(proc.stdout.split()[0]) >= 22
    # and no file imports them anywhere, a function body included (the
    # workloads import their frameworks inside main())
    files = sorted((REPO / "tf_operator_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert len(files) >= 22
    assert not bad, bad


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card chip_smoke.py exits non-zero and prints no result,
    both in the repo and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("exercises the no-CUDA exit")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script, path in ((REPO, "chip_smoke.py", str(REPO)),
                              (tmp_path, str(alone), "")):
        env = dict(os.environ, PYTHONPATH=path)
        proc = subprocess.run([sys.executable, script], cwd=str(cwd),
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_port_lm_tpujob_succeeds_on_the_local_process_runtime(tmp_path):
    """The control plane launches the port's workload as a pod process
    (the topology env it injects is what the port's runner reads) and the
    job reaches Succeeded with falling loss."""
    from tf_operator_tpu.api.core import Container, ObjectMeta, PodTemplateSpec
    from tf_operator_tpu.api.types import (ReplicaSpec, ReplicaType, TPUJob,
                                           TPUJobSpec)
    from tf_operator_tpu.controller.controller import TPUJobController
    from tf_operator_tpu.runtime.local import LocalProcessCluster
    from tf_operator_tpu.sdk.client import TPUJobClient

    cluster = LocalProcessCluster(
        workdir=str(tmp_path / "work"),
        extra_env={"TPUJOB_FORCE_PLATFORM": "cpu", "PYTHONPATH": str(REPO),
                   "OMP_NUM_THREADS": "1"})
    controller = TPUJobController(cluster, threadiness=2,
                                  resolver=cluster.resolver)
    controller.start()
    try:
        client = TPUJobClient(cluster)
        client.create(TPUJob(
            metadata=ObjectMeta(name="port-lm"),
            spec=TPUJobSpec(replica_specs={ReplicaType.WORKER: ReplicaSpec(
                replicas=1,
                template=PodTemplateSpec(containers=[Container(
                    name="tensorflow", image="local",
                    command=[sys.executable, "-m",
                             "tf_operator_tpu_torch.workloads.lm"],
                    args=["--steps", "11", "--lr", "3e-3"] + TINY,
                )]),
            )}),
        ))
        client.wait_for_job("port-lm", timeout=180)
        logs = "\n".join(client.get_logs("port-lm").values())
        assert client.is_job_succeeded("port-lm"), logs
        got = losses(logs)
        assert got[10] < got[0] and "done" in logs
    finally:
        controller.stop()
        cluster.close()
