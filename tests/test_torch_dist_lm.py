"""The port's distributed LM step over gloo ranks against the one-process
port and the JAX LM under the same mesh.

Each case starts from the same flax params (carried over with
`params_from_flax`) and takes 4 AdamW steps (`lm_optimizer`: clip 1.0,
weight decay 0.1, warmup + cosine) on the same global batches of
`synthetic_tokens`, in f32: on 2 or 4 spawned ranks
(`torch_dist_worker.py`; each rank keeps its `shard_batch` of every batch),
on one process of the port, and in the JAX package over a mesh of as many
virtual CPU devices.  Losses and parameters agree with the one-process port
within 5e-5 and losses with JAX within 5e-5, the reference's "same update
math" tolerance (tests/test_torch_train.py): the ranks sum their gradients
in another order.  Every rank ends with the same parameters.  Ring and
Ulysses give the same loss within 1e-5, as `__graft_entry__._dryrun_ulysses`
asserts for the JAX package.  Last, a 2-worker TPUJob on the local process
runtime runs the port's workload data parallel to Succeeded.
"""
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import transformer as J
from tf_operator_tpu.parallel.mesh import build_mesh as j_build_mesh
from tf_operator_tpu.train import optim as joptim
from tf_operator_tpu.train.state import create_train_state as j_create
from tf_operator_tpu.train.step import lm_loss_fn as j_loss_fn
from tf_operator_tpu.train.step import make_train_step as j_make_step
from tf_operator_tpu.train.step import shard_batch as j_shard_batch
from tf_operator_tpu.train.step import shard_train_state
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models.convert import params_from_flax
from tf_operator_tpu_torch.train import data as tdata
from tf_operator_tpu_torch.train import optim as toptim
from tf_operator_tpu_torch.train.state import create_train_state
from tf_operator_tpu_torch.train.step import lm_loss_fn, make_train_step
from torch_dist_worker import World

torch.set_num_threads(1)

ATOL = 5e-5
REPO = Path(__file__).resolve().parent.parent
SMALL = dict(num_layers=1, d_model=64, num_heads=4, vocab_size=128,
             max_len=32)
ARCHS = {"gpt": ("gpt_small_config", dict(d_ff=128)),
         "llama": ("llama_style_config", dict(num_kv_heads=2, d_ff=96))}
OPT = dict(schedule="cosine", warmup_steps=2, total_steps=5,
           weight_decay=0.1, grad_clip=1.0)
LR = 3e-3
# name -> (ranks, mesh, arch, seq_parallel, grad_accum, config overrides);
# gpt checks the learned positions' offset under sp, llama the rope offset
# and GQA.  The last case (two layers under remat: each layer's ring shifts
# run again in the backward's recompute) is held against the one-process
# port only, sparing the JAX compile of a second model.
CASES = {
    "dp2": (2, {"dp": 2}, "gpt", "ring", 1, {}),
    "dp2_accum2": (2, {"dp": 2}, "gpt", "ring", 2, {}),
    "sp2_ring": (2, {"sp": 2}, "gpt", "ring", 1, {}),
    "sp2_ring_llama": (2, {"sp": 2}, "llama", "ring", 1, {}),
    "sp2_ulysses_llama": (2, {"sp": 2}, "llama", "ulysses", 1, {}),
    "dp2_sp2_ring": (4, {"dp": 2, "sp": 2}, "gpt", "ring", 1, {}),
    "dp2_sp2_ulysses_llama": (4, {"dp": 2, "sp": 2}, "llama", "ulysses", 1,
                              {}),
    "sp2_ring_llama_2layers_remat": (2, {"sp": 2}, "llama", "ring", 1,
                                     dict(num_layers=2, remat=True)),
}


def batches():
    return [b["tokens"] for b, _ in
            zip(tdata.synthetic_tokens(4, 33, 128, seed=1), range(4))]


def _init_without_mesh(name):
    """The flax params of the case's model.  They do not depend on the
    mesh; initialising without it skips an eager (uncompiled) pass of the
    sequence-parallel attention."""
    _, _, arch, _, _, extra = CASES[name]
    cfg = getattr(J, ARCHS[arch][0])(dtype=jnp.float32,
                                     **{**SMALL, **ARCHS[arch][1], **extra})
    return jax.device_get(J.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32))["params"])


def jax_run(name, init):
    """The JAX LM's losses under the case's mesh, from params `init`."""
    ranks, axes, arch, strategy, accum, _ = CASES[name]
    mesh = j_build_mesh(axes, devices=jax.devices()[:ranks])
    preset = getattr(J, ARCHS[arch][0])
    state = j_create(jax.random.PRNGKey(0),
                     J.TransformerLM(preset(dtype=jnp.float32, **SMALL,
                                            **ARCHS[arch][1])),
                     joptim.lm_optimizer(LR, **OPT),
                     jnp.zeros((2, 32), jnp.int32))
    state = state.replace(params=init)
    model = J.TransformerLM(preset(dtype=jnp.float32, mesh=mesh,
                                   ring_axis="sp", seq_parallel=strategy,
                                   **SMALL, **ARCHS[arch][1]))
    state = shard_train_state(state, mesh)
    step = j_make_step(j_loss_fn(model.apply), donate=False,
                       grad_accum=accum)
    losses = []
    for tokens in batches():
        state, metrics = step(state, j_shard_batch({"tokens": tokens}, mesh))
        losses.append(float(metrics["loss"]))
    return losses


def port_config(name):
    _, _, arch, _, _, extra = CASES[name]
    return dict(dtype=torch.float32, **{**SMALL, **ARCHS[arch][1], **extra})


def port_run(name, init):
    """The one-process port: (losses, params)."""
    _, _, arch, _, accum, _ = CASES[name]
    cfg = getattr(T, ARCHS[arch][0])(**port_config(name))
    model = T.TransformerLM(cfg)
    model.load_state_dict(init)
    state = create_train_state(model, toptim.lm_optimizer(LR, **OPT),
                               seed=None)
    step = make_train_step(lm_loss_fn(model), grad_accum=accum)
    losses = []
    for tokens in batches():
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(metrics["loss"]))
    return losses, model.state_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the JAX losses, the one-process port's (losses, params),
    and each rank's results; one world per rank count, running while the
    references are computed here."""
    inits = {name: _init_without_mesh(name) for name in CASES}
    jobs = {2: [], 4: []}
    for name, (ranks, axes, arch, strategy, accum, _) in CASES.items():
        jobs[ranks].append(dict(
            name=name, mesh=axes, preset=ARCHS[arch][0],
            config=port_config(name), seq_parallel=strategy,
            grad_accum=accum, init=params_from_flax(inits[name]),
            opt=dict(peak_lr=LR, **OPT),
            batches=[torch.from_numpy(b) for b in batches()]))
    worlds = {ranks: World(tmp_path_factory.mktemp(f"world{ranks}"), ranks,
                           dict(kind="lm", cases=cases))
              for ranks, cases in jobs.items()}
    out = {}
    for name, (_, _, _, _, _, extra) in CASES.items():
        init = params_from_flax(inits[name])
        out[name] = {"jax": None if extra else jax_run(name, inits[name]),
                     "port": port_run(name, init), "init": init}
    for ranks, world in worlds.items():
        results = world.results()
        for case in jobs[ranks]:
            out[case["name"]]["ranks"] = [r[case["name"]] for r in results]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_steps_match_one_process_and_jax(name, runs):
    run = runs[name]
    port_losses, port_params = run["port"]
    first = run["ranks"][0]
    got = first["losses"].tolist()
    np.testing.assert_allclose(got, port_losses, atol=ATOL)
    if run["jax"] is not None:
        np.testing.assert_allclose(got, run["jax"], atol=ATOL)
    moved = 0.0
    for key, want in port_params.items():
        torch.testing.assert_close(first["params"][key], want, atol=ATOL,
                                   rtol=0, msg=key)
        moved = max(moved, float((want - run["init"][key]).abs().max()))
    assert moved > 100 * ATOL  # the steps really moved the params
    for other in run["ranks"][1:]:
        assert torch.equal(other["losses"], first["losses"])
        for key, value in first["params"].items():
            assert torch.equal(other["params"][key], value), key


def test_ring_and_ulysses_give_the_same_lm_loss(runs):
    ring = runs["sp2_ring_llama"]["ranks"][0]["losses"]
    ulysses = runs["sp2_ulysses_llama"]["ranks"][0]["losses"]
    assert float((ring - ulysses).abs().max()) < 1e-5


def losses(log):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step (\d+) loss (\S+)$", log, re.M)}


def test_two_worker_tpujob_trains_data_parallel(tmp_path):
    """The control plane launches the port's workload as two pod
    processes with mesh {"dp": 2}; they join one gloo group at the
    injected coordinator address, rank 0 logs, and the job reaches
    Succeeded with falling loss."""
    from tf_operator_tpu.api.core import Container, ObjectMeta, PodTemplateSpec
    from tf_operator_tpu.api.types import (ReplicaSpec, ReplicaType, TPUJob,
                                           TPUJobSpec, TPUTopology)
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
            metadata=ObjectMeta(name="port-lm-dp"),
            spec=TPUJobSpec(replica_specs={ReplicaType.WORKER: ReplicaSpec(
                replicas=2, tpu=TPUTopology(mesh={"dp": 2}),
                template=PodTemplateSpec(containers=[Container(
                    name="tensorflow", image="local",
                    command=[sys.executable, "-m",
                             "tf_operator_tpu_torch.workloads.lm"],
                    args=["--steps", "11", "--lr", "3e-3", "--batch", "4",
                          "--seq-len", "16", "--vocab", "64", "--layers",
                          "1", "--d-model", "64"],
                )]),
            )}),
        ))
        client.wait_for_job("port-lm-dp", timeout=180)
        logs = client.get_logs("port-lm-dp")
        text = "\n".join(logs.values())
        assert client.is_job_succeeded("port-lm-dp"), text
        got = losses(text)
        assert got[10] < got[0] and text.count("done") == 1
    finally:
        controller.stop()
        cluster.close()
