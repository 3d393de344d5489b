"""The port's classification workloads over processes: the data-parallel
step with global BatchNorm over gloo ranks against the one-process port
and the JAX package, the workloads as pods run them, and their flags,
exits and log lines against the JAX workloads'.

ResNet18 (10 classes, 32x32 images, global batch 8) takes 3 SGD steps (lr
0.01, momentum 0.9) from flax's init on 2 ranks of dp (`torch_dist_worker.py`,
each rank on its 4 rows), in one process on the global batch, and in the
JAX package under a dp 2 mesh of virtual CPU devices, in f32.  Loss,
params and batch_stats agree within 2e-5 (the tolerance of the one-process
SGD test, `tests/test_torch_resnet.py`: the ranks sum in another order),
and the ranks end bit-equal.  A ResNet whose BatchNorms leave out the dp
group (each rank normalising over its own 4 rows: a planted fault) must
not agree.  ViT (2 layers, d 64) takes 3 adamw steps at dp 2 against the
one-process port within 5e-5 (the key biases aside, as in
`tests/test_torch_vit_bert.py`).

The same world also runs: ResNet18 at dp 2 with grad_accum 2 against JAX
at dp 2 with grad_accum 2 (each microbatch is each rank's share of the
global batch's part, so BatchNorm's statistics cover the same rows; within
2e-5), the eval step at dp 2 against the one-process eval of the global
batch (within 1e-6: the same forward, the mean weighted by rows), and
ResNet18 and ViT fully sharded (`{"fsdp": 2}`) and under ZeRO over dp 2
against the one-process port (2e-5, 5e-5).

The workloads run as processes too: over 2 ranks on an axis that neither
splits the batch nor shards the model (pp and ep for all three, tp and sp
for ResNet), their rank 0 logs the one-process run's losses, as the JAX
workloads replicate the step there, and every rank takes rank 0's batch
and holds its parameters: rank 1 reads its own stream (its replica index
seeds ViT's and BERT's; ResNet's native loader hands batches over in no
fixed order), so only the broadcast over the replicas makes them agree.
ViT and BERT also run over 2 ranks of tp (the blocks sharded) and of sp
(the sequence split; ViT at 20x20, whose 26 tokens split in two), their
rank 0 logging the one-process run's losses within 1e-2 (bf16); ViT at
TINY's 17 tokens exits 2 under sp naming the rule.
"""
import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models.resnet import ResNet18 as JResNet18
from tf_operator_tpu.models import vit as JV
from tf_operator_tpu.parallel.mesh import build_mesh as j_build_mesh
from tf_operator_tpu.train import data as jdata
from tf_operator_tpu.train.state import create_train_state as j_create
from tf_operator_tpu.train.step import classification_loss_fn as j_loss_fn
from tf_operator_tpu.train.step import make_train_step as j_make_step
from tf_operator_tpu.train.step import shard_batch as j_shard_batch
from tf_operator_tpu.train.step import shard_train_state
from tf_operator_tpu.workloads import bert as j_bert
from tf_operator_tpu.workloads import resnet as j_resnet
from tf_operator_tpu.workloads import vit as j_vit
from tf_operator_tpu_torch.models import resnet as R
from tf_operator_tpu_torch.models import vit as V
from tf_operator_tpu_torch.models.convert import (resnet_from_flax,
                                                  vit_from_flax)
from tf_operator_tpu_torch.train import optim
from tf_operator_tpu_torch.train.state import create_train_state
from tf_operator_tpu_torch.train.step import (classification_loss_fn,
                                              classification_metrics,
                                              make_eval_step,
                                              make_train_step)
from tf_operator_tpu_torch.workloads import bert, resnet, vit
from torch_dist_worker import World, launch_workload, replica_steps

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RESNET_ATOL = 2e-5
VIT_ATOL = 5e-5
RESNET_LR = 0.01
VIT_LR = 1e-3
VIT_CONFIG = dict(num_layers=2, num_heads=4, d_model=64, d_ff=128,
                  max_len=17)


def resnet_batches():
    return [b for b, _ in zip(jdata.synthetic_images(8, 32, 10, seed=1),
                              range(3))]


def vit_batches():
    out = []
    for seed in (1, 2, 3):
        rng = np.random.RandomState(seed)
        out.append({"x": rng.randn(8, 16, 16, 3).astype(np.float32),
                    "label": rng.randint(0, 10, 8).astype(np.int32)})
    return out


def eval_batch():
    """8 images whose rows the two ranks split 4 and 4: the port's eval
    step must weigh them into the global batch's loss and accuracy."""
    return next(jdata.synthetic_images(8, 32, 10, seed=7))


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def one_process(model, recipe, batches):
    state = create_train_state(model, recipe, seed=None)
    step = make_train_step(classification_loss_fn(model))
    losses = []
    for batch in batches:
        state, metrics = step(state, torch_batch(batch))
        losses.append(float(metrics["loss"]))
    return losses, model.state_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank world's results, started first; meanwhile the one-process
    port's and JAX's."""
    jmodel = JResNet18(num_classes=10, dtype=jnp.float32)
    variables = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), train=True))
    r_init = resnet_from_flax(variables["params"], variables["batch_stats"])
    jvit = JV.ViT(JV.vit_base_config(dtype=jnp.float32, **VIT_CONFIG),
                  num_classes=10, patch_size=4)
    v_init = vit_from_flax(jax.device_get(jvit.init(
        jax.random.PRNGKey(0), vit_batches()[0]["x"])["params"]))
    to_torch = [{k: torch.from_numpy(v) for k, v in b.items()}
                for b in resnet_batches()]
    vit_torch = [torch_batch(b) for b in vit_batches()]
    cases = [
        dict(name="resnet18", model="resnet18", lr=RESNET_LR, init=r_init,
             batches=to_torch),
        dict(name="resnet18_per_rank_bn", model="resnet18", lr=RESNET_LR,
             init=r_init, batches=to_torch, per_rank_bn=True),
        dict(name="vit", model="vit", lr=VIT_LR, init=v_init,
             config=VIT_CONFIG, batches=vit_torch),
        dict(name="resnet18_accum2", model="resnet18", lr=RESNET_LR,
             init=r_init, batches=to_torch[:1], grad_accum=2),
        dict(name="resnet18_eval", model="resnet18", lr=RESNET_LR,
             init=r_init, batches=[], eval_batch=torch_batch(eval_batch())),
        dict(name="resnet18_fsdp2", model="resnet18", lr=RESNET_LR,
             init=r_init, batches=to_torch, mesh={"fsdp": 2}),
        dict(name="resnet18_zero", model="resnet18", lr=RESNET_LR,
             init=r_init, batches=to_torch, zero=True),
        dict(name="vit_fsdp2", model="vit", lr=VIT_LR, init=v_init,
             config=VIT_CONFIG, batches=vit_torch, mesh={"fsdp": 2}),
        dict(name="vit_zero", model="vit", lr=VIT_LR, init=v_init,
             config=VIT_CONFIG, batches=vit_torch, zero=True),
    ]
    world = World(tmp_path_factory.mktemp("classify"), 2,
                  dict(kind="classify", cases=cases))

    model = R.ResNet18(num_classes=10, dtype=torch.float32)
    model.load_state_dict(r_init)
    port = one_process(model, optim.sgd(RESNET_LR), resnet_batches())
    vmodel = V.ViT(V.vit_base_config(dtype=torch.float32, **VIT_CONFIG),
                   num_classes=10, patch_size=4, image_size=16)
    vmodel.load_state_dict(v_init)
    vit_port = one_process(vmodel, optim.adamw(VIT_LR), vit_batches())

    mesh = j_build_mesh({"dp": 2}, devices=jax.devices()[:2])
    state = j_create(jax.random.PRNGKey(0), jmodel,
                     optax.sgd(RESNET_LR, 0.9), jnp.zeros((2, 32, 32, 3)),
                     init_kwargs={"train": True})
    state = shard_train_state(state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"]),
        mesh)
    step = j_make_step(j_loss_fn(jmodel.apply, has_batch_stats=True,
                                 model_kwargs={"train": True}),
                       has_batch_stats=True, donate=False)
    jax_losses = []
    for batch in resnet_batches():
        state, metrics = step(state, j_shard_batch(batch, mesh))
        jax_losses.append(float(metrics["loss"]))
    jax_state = resnet_from_flax(jax.device_get(state.params),
                                 jax.device_get(state.batch_stats))

    # one step at grad_accum 2 under the same dp 2 mesh
    state = j_create(jax.random.PRNGKey(0), jmodel,
                     optax.sgd(RESNET_LR, 0.9), jnp.zeros((2, 32, 32, 3)),
                     init_kwargs={"train": True})
    state = shard_train_state(state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"]),
        mesh)
    step = j_make_step(j_loss_fn(jmodel.apply, has_batch_stats=True,
                                 model_kwargs={"train": True}),
                       has_batch_stats=True, donate=False, grad_accum=2)
    state, metrics = step(state, j_shard_batch(resnet_batches()[0], mesh))
    jax_accum = ([float(metrics["loss"])],
                 resnet_from_flax(jax.device_get(state.params),
                                  jax.device_get(state.batch_stats)))

    model = R.ResNet18(num_classes=10, dtype=torch.float32)
    model.load_state_dict(r_init)
    eval_port = make_eval_step(classification_metrics(model))(
        create_train_state(model, optim.sgd(RESNET_LR), seed=None),
        torch_batch(eval_batch()))
    ranks = world.results()
    return dict(port=port, vit_port=vit_port, jax=(jax_losses, jax_state),
                jax_accum=jax_accum, eval_port=eval_port,
                ranks={case["name"]: [r[case["name"]] for r in ranks]
                       for case in cases}, r_init=r_init)


def assert_state_close(got, want, atol, skip=()):
    assert set(got) == set(want)
    for key, value in want.items():
        if not key.endswith(skip):
            torch.testing.assert_close(got[key], value, atol=atol, rtol=0,
                                       msg=key)


@pytest.mark.parametrize("against", ["one_process", "jax_dp2"])
def test_resnet_dp2_global_batchnorm_matches(runs, against):
    losses, state = (runs["port"] if against == "one_process"
                     else runs["jax"])
    first = runs["ranks"]["resnet18"][0]
    np.testing.assert_allclose(first["losses"].numpy(), losses,
                               atol=RESNET_ATOL, rtol=0)
    assert_state_close(first["state"], state, RESNET_ATOL)
    moved = max(float((state[k] - runs["r_init"][k]).abs().max())
                for k in state)
    assert moved > 100 * RESNET_ATOL


@pytest.mark.parametrize("case", ["resnet18", "vit"])
def test_ranks_end_bit_equal(runs, case):
    first, other = runs["ranks"][case]
    assert torch.equal(first["losses"], other["losses"])
    for key, value in first["state"].items():
        assert torch.equal(other["state"][key], value), key


def test_planted_per_rank_batchnorm_fails(runs):
    """Each rank's BatchNorm over its own rows trains another model: its
    losses and running statistics are off by far more than the tolerance,
    and the ranks' running statistics part."""
    first, other = runs["ranks"]["resnet18_per_rank_bn"]
    assert not torch.equal(first["state"]["bn_init.running_mean"],
                           other["state"]["bn_init.running_mean"])
    losses, state = runs["port"]
    assert float(np.abs(first["losses"].numpy() - losses).max()) > \
        100 * RESNET_ATOL
    with pytest.raises(AssertionError):
        assert_state_close(first["state"], state, RESNET_ATOL)


def test_resnet_dp2_grad_accum_matches_jax(runs):
    """Microbatch i of each rank is its share of the global batch's i-th
    part, as JAX's reshape of the global batch gives it: BatchNorm's
    statistics then cover the same rows."""
    losses, state = runs["jax_accum"]
    first = runs["ranks"]["resnet18_accum2"][0]
    np.testing.assert_allclose(first["losses"].numpy(), losses,
                               atol=RESNET_ATOL, rtol=0)
    assert_state_close(first["state"], state, RESNET_ATOL)


def test_eval_step_dp2_gives_the_global_batch_metrics(runs):
    want = runs["eval_port"]
    for rank in runs["ranks"]["resnet18_eval"]:
        assert set(rank["eval"]) == {"loss", "accuracy"}
        for key, value in want.items():
            assert abs(float(rank["eval"][key]) - float(value)) <= 1e-6, key


@pytest.mark.parametrize("case", ["resnet18_fsdp2", "resnet18_zero",
                                  "vit_fsdp2", "vit_zero"])
def test_fsdp_and_zero_match_one_process(runs, case):
    if case.startswith("resnet"):
        (losses, state), atol, skip = runs["port"], RESNET_ATOL, ()
    else:
        (losses, state), atol, skip = (runs["vit_port"], VIT_ATOL,
                                       ("attn.key.bias",))
    for rank in runs["ranks"][case]:
        np.testing.assert_allclose(rank["losses"].numpy(), losses, atol=atol,
                                   rtol=0)
        assert_state_close(rank["state"], state, atol, skip=skip)


def test_vit_dp2_matches_one_process(runs):
    losses, state = runs["vit_port"]
    first = runs["ranks"]["vit"][0]
    np.testing.assert_allclose(first["losses"].numpy(), losses,
                               atol=VIT_ATOL, rtol=0)
    assert_state_close(first["state"], state, VIT_ATOL,
                       skip=("attn.key.bias",))


# ---------------------------------------------------------------------------
# the workloads: flags, exits, log lines, and a TPUJob of the port's ResNet

WORKLOADS = {"resnet": (resnet, j_resnet), "vit": (vit, j_vit),
             "bert": (bert, j_bert)}
TINY = {
    "resnet": ["--depth", "18", "--batch", "4", "--image-size", "32",
               "--num-classes", "10"],
    "vit": ["--batch", "4", "--image-size", "16", "--patch-size", "4",
            "--layers", "1", "--d-model", "64", "--num-classes", "10"],
    "bert": ["--batch", "4", "--seq-len", "16", "--layers", "1",
             "--d-model", "64"],
}
TOPOLOGY_ENV = ("TPUJOB_MESH_SHAPE", "TPUJOB_NUM_PROCESSES",
                "TPUJOB_PROCESS_ID", "TPUJOB_ZERO_SHARD_WEIGHT_UPDATE",
                "TPUJOB_VIRTUAL_REPLICAS", "TPUJOB_PHYSICAL_REPLICAS",
                "TF_CONFIG")
PROCESS_0_OF = {"TPUJOB_PROCESS_ID": "0",
                "TPUJOB_COORDINATOR_ADDRESS": "127.0.0.1:1"}


class _Parsed(Exception):
    pass


def parser_defaults(main, monkeypatch):
    """{dest: default} of the parser `main` builds (stopped at its
    parse_args, before anything else runs)."""
    def stop(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as caught:
        main([])
    monkeypatch.undo()
    return {a.dest: a.default for a in caught.value.args[0]._actions
            if a.dest != "help"}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_flags_and_defaults_are_the_reference_workloads(name, monkeypatch):
    ours, theirs = WORKLOADS[name]
    got = parser_defaults(ours.main, monkeypatch)
    want = parser_defaults(theirs.main, monkeypatch)
    assert {k: got[k] for k in want} == want
    # bert alone adds --log-every, at the step interval it logs anyway
    assert set(got) - set(want) == ({"log_every"} if name == "bert"
                                    else set())


@pytest.fixture
def clean_env(monkeypatch):
    for key in TOPOLOGY_ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("TPUJOB_FORCE_PLATFORM", "cpu")
    return monkeypatch


def _multi(n, mesh):
    return {**PROCESS_0_OF, "TPUJOB_NUM_PROCESSES": str(n),
            "TPUJOB_MESH_SHAPE": json.dumps(mesh)}


EXITS = [
    ("fsdp", _multi(8, {"dp": 2, "fsdp": 4}),
     "--batch 4 must split over dp=2 x fsdp=4"),
    ("sp", _multi(2, {"sp": 2}), "17 tokens (patches + CLS) must divide by "
     "sp=2: ring attention needs T divisible by the sp axis size"),
    ("mesh", _multi(2, {"dp": 4}),
     "invalid mesh: mesh axes {'dp': 4} require 4 devices, but 2 are "
     "available"),
    ("batch", _multi(8, {"dp": 8}), "--batch 4 must split over dp=8"),
]
# every workload runs tp and sp (ResNet's ranks replicate the step over
# them, `test_replicated_axis_trains_as_one_process`; ViT's and BERT's
# split the model or the sequence, `test_tp_and_sp_train_as_one_process`),
# but ViT's 17 tokens at TINY do not split over sp 2
EXIT_CASES = [(name, *e) for e in EXITS for name in WORKLOADS
              if e[0] != "sp" or name == "vit"]


@pytest.mark.parametrize("name,what,env,message", EXIT_CASES,
                         ids=[f"{c[1]}-{c[0]}" for c in EXIT_CASES])
def test_unported_or_unfit_topology_exits_2(clean_env, capsys, name, what,
                                            env, message):
    """Checked before any group is joined (the coordinator address is
    never dialled)."""
    for key, value in env.items():
        clean_env.setenv(key, value)
    rc = WORKLOADS[name][0].main(["--steps", "1"] + TINY[name])
    out = capsys.readouterr().out
    assert rc == 2
    assert message in out


REPLICATED = [("resnet", "pp"), ("resnet", "ep"), ("resnet", "tp"),
              ("resnet", "sp"), ("vit", "pp"), ("vit", "ep"), ("bert", "pp"),
              ("bert", "ep")]
# the encoders' axes that shard the model (tp) or split the sequence (sp);
# ViT under sp at 20x20 (25 patches + CLS: 26 tokens over sp 2)
SPLIT = [("vit", "tp"), ("bert", "tp"), ("vit", "sp"), ("bert", "sp")]
VIT_SP = ["--image-size", "20"]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(name, env_extra, native=False, extra=()):
    """The workload's main through the worker's workload mode (every rank
    prints its loss, batch and parameter digests), the native image loader
    off unless `native`: its threads hand batches over in no fixed order,
    so two runs would not read one stream.  `extra` flags follow TINY's."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUJOB_") and k != "TF_CONFIG"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TPUJOB_FORCE_PLATFORM="cpu", **env_extra)
    return launch_workload(name, ["--steps", "2", "--log-every", "1"]
                           + TINY[name] + list(extra), env, native)


def _ranks(name, axis, native=False, extra=()):
    """Two ranks over {axis: 2}, each with its own replica index, as a
    TPUJob's pods get theirs."""
    address = f"127.0.0.1:{_free_port()}"
    return [_launch(name, dict(
        TPUJOB_NUM_PROCESSES="2", TPUJOB_PROCESS_ID=str(rank),
        TPUJOB_REPLICA_INDEX=str(rank), TPUJOB_COORDINATOR_ADDRESS=address,
        TPUJOB_MESH_SHAPE=json.dumps({axis: 2})), native, extra)
        for rank in range(2)]


def _extra(name, axis):
    return VIT_SP if (name, axis) == ("vit", "sp") else ()


@pytest.fixture(scope="module")
def replicated_logs():
    """Every workload in one process, over 2 ranks on each axis of
    REPLICATED and SPLIT, and ResNet over pp on the native loader, started
    at once; {key: each process's log} (("vit", "sp-one"): ViT in one
    process at sp's image size)."""
    procs = {(name, None): [_launch(name, {})] for name in WORKLOADS}
    procs["vit", "sp-one"] = [_launch("vit", {}, extra=VIT_SP)]
    for name, axis in REPLICATED + SPLIT:
        procs[name, axis] = _ranks(name, axis, extra=_extra(name, axis))
    procs["resnet", "native"] = _ranks("resnet", "pp", native=True)
    logs = {}
    try:
        for key, ranks in procs.items():
            outs = [p.communicate(timeout=240)[0] for p in ranks]
            assert all(p.returncode == 0 for p in ranks), "\n".join(outs)
            logs[key] = outs
    finally:
        for ranks in procs.values():
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return logs


def _replicas_agree(logs, steps):
    """Every rank took the same batch, computed the same loss and holds the
    same parameters after each of `steps` steps."""
    per_rank = [replica_steps(log) for log in logs]
    assert [s[0] for s in per_rank[0]] == [str(i) for i in range(steps)]
    for rank, seen in enumerate(per_rank[1:], 1):
        assert seen == per_rank[0], f"rank {rank}: {seen} != {per_rank[0]}"


@pytest.mark.parametrize("name,axis", REPLICATED,
                         ids=[f"{a}-{n}" for n, a in REPLICATED])
def test_replicated_axis_trains_as_one_process(replicated_logs, name, axis):
    """An axis that neither splits the batch nor shards the model
    replicates the step, as in the JAX workloads: the two ranks' run logs
    the one-process run's losses (printed to 4 decimals) from rank 0
    alone, from the one-process run's batches, and rank 1 took rank 0's
    batches and holds its parameters."""
    rank0, rank1 = replicated_logs[name, axis]
    want = re.findall(r"^step (\d+) loss (\S+)$",
                      replicated_logs[name, None][0], re.M)
    assert [i for i, _ in want] == ["0", "1"]
    assert re.findall(r"^step (\d+) loss (\S+)$", rank0, re.M) == want
    last = {"resnet": r"^done: 2 steps", "vit": r"^final loss ",
            "bert": r"^done$"}[name]
    assert re.search(last, rank0, re.M), rank0
    assert not re.search(r"^step \d+ loss", rank1, re.M)
    _replicas_agree([rank0, rank1], 2)
    assert ([s[2] for s in replica_steps(rank0)]
            == [s[2] for s in replica_steps(replicated_logs[name, None][0])])


@pytest.mark.parametrize("name,axis", SPLIT,
                         ids=[f"{a}-{n}" for n, a in SPLIT])
def test_tp_and_sp_train_as_one_process(replicated_logs, name, axis):
    """tp shards the blocks (and BERT's token embedding) over the two
    ranks, sp splits the sequence; both share the rows, which they take
    from rank 0's stream.  Rank 0 logs the one-process run's losses
    within 1e-2 (the workload computes in bf16, and the split sums its
    partial products in another order), rank 1 logs none, both ranks
    report one loss at every step, took the same batch (BERT under sp:
    its halves of each sequence) and, under sp, hold the same parameters
    (under tp each holds its slices)."""
    rank0, rank1 = replicated_logs[name, axis]
    one = replicated_logs[name, "sp-one" if (name, axis) == ("vit", "sp")
                          else None][0]
    want = re.findall(r"^step (\d+) loss (\S+)$", one, re.M)
    got = re.findall(r"^step (\d+) loss (\S+)$", rank0, re.M)
    assert [i for i, _ in got] == [i for i, _ in want] == ["0", "1"]
    for (_, a), (_, b) in zip(got, want):
        assert abs(float(a) - float(b)) <= 1e-2, (got, want)
    last = {"vit": r"^final loss ", "bert": r"^done$"}[name]
    assert re.search(last, rank0, re.M), rank0
    assert not re.search(r"^step \d+ loss", rank1, re.M)
    steps = [replica_steps(log) for log in (rank0, rank1)]
    assert [s[0] for s in steps[0]] == ["0", "1"]
    assert [s[1] for s in steps[0]] == [s[1] for s in steps[1]]
    same_batch = not (name, axis) == ("bert", "sp")
    assert ([s[2] for s in steps[0]] == [s[2] for s in steps[1]]) \
        == same_batch
    assert ([s[3] for s in steps[0]] == [s[3] for s in steps[1]]) \
        == (axis == "sp")


def test_replicas_take_one_batch_from_the_native_loader(replicated_logs):
    """ResNet over {"pp": 2} on the native image loader, whose threads hand
    batches over in no fixed order: the broadcast gives rank 1 rank 0's
    batches, so the replicas agree step by step."""
    rank0, rank1 = replicated_logs["resnet", "native"]
    assert "image source: native" in rank0
    _replicas_agree([rank0, rank1], 2)


def test_vit_patch_size_that_does_not_divide_exits_2(clean_env, capsys):
    assert vit.main(["--image-size", "18", "--patch-size", "4"]) == 2
    assert "--image-size 18 must divide by --patch-size 4" in \
        capsys.readouterr().out


STEP_TIME = re.compile(r"^step time (\S+) ms over steps 1-2, (\S+) "
                       r"(images|sequences)/s$", re.M)
LAST_LINE = {"resnet": r"^done: 3 steps, \S+ img/s$",
             "vit": r"^final loss \S+ \(\S+ images/sec\)$",
             "bert": r"^done$"}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_runs_with_the_reference_log_lines(clean_env, capsys, name):
    """The reference's lines (role, a loss line per --log-every, the last
    line), the zero knob at dp 1 running dense, and the step time line."""
    clean_env.setenv("TPUJOB_ZERO_SHARD_WEIGHT_UPDATE", "1")
    rc = WORKLOADS[name][0].main(["--steps", "3", "--log-every", "1"]
                                 + TINY[name])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"{name} workload: role=worker index=0" in out
    assert "zero-shard-weight-update: dp axis size is 1, running dense" \
        in out
    losses = re.findall(r"^step (\d+) loss (\S+)$", out, re.M)
    assert [int(i) for i, _ in losses] == [0, 1, 2]
    assert all(np.isfinite(float(v)) for _, v in losses)
    m = STEP_TIME.search(out)
    assert m and float(m.group(1)) > 0
    assert re.search(LAST_LINE[name], out, re.M), out
    if name == "resnet":
        assert re.search(r"^image source: (native|python) ", out, re.M)


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_exits_nonzero_without_cuda_or_cpu_knob(name):
    env = {k: v for k, v in os.environ.items()
           if k not in TOPOLOGY_ENV + ("TPUJOB_FORCE_PLATFORM",)}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"tf_operator_tpu_torch.workloads.{name}",
         "--steps", "1"] + TINY[name], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "TPUJOB_FORCE_PLATFORM=cpu" in proc.stdout
    assert "step 0" not in proc.stdout


def test_two_worker_resnet_tpujob_succeeds(tmp_path):
    """The control plane launches the port's ResNet workload as two pod
    processes with mesh {"dp": 2}; they join one gloo group (BatchNorm's
    statistics over both), rank 0 logs, and the job reaches Succeeded."""
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
            metadata=ObjectMeta(name="port-resnet-dp"),
            spec=TPUJobSpec(replica_specs={ReplicaType.WORKER: ReplicaSpec(
                replicas=2, tpu=TPUTopology(mesh={"dp": 2}),
                template=PodTemplateSpec(containers=[Container(
                    name="tensorflow", image="local",
                    command=[sys.executable, "-m",
                             "tf_operator_tpu_torch.workloads.resnet"],
                    args=["--steps", "3", "--log-every", "1"]
                    + TINY["resnet"],
                )]),
            )}),
        ))
        client.wait_for_job("port-resnet-dp", timeout=180)
        text = "\n".join(client.get_logs("port-resnet-dp").values())
        assert client.is_job_succeeded("port-resnet-dp"), text
        assert text.count("done: 3 steps") == 1
        assert len(re.findall(r"^step \d+ loss \S+$", text, re.M)) == 3
    finally:
        controller.stop()
        cluster.close()
