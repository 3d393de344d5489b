"""The port's tensor parallel, FSDP and ZeRO layouts against the JAX
package's.

Pure layout parity (no processes): for GPT-small and llama 12/4 under
{"tp": 2}, {"fsdp": 2}, {"fsdp": 2, "tp": 2} and {"dp": 2, "tp": 2}, every
port parameter's layout, mapped back onto the flax dims through
`models/convert.flax_param_map`, is the JAX `combined_spec`; the ZeRO
plan's JSON is JAX's `build_zero_plan(...).to_json()`, and so is the
per-rank optimizer-state size it prices.

Training parity: an LM (2 layers, d_model 128 = 2 heads, vocab 256, T 32,
global batch 8, f32) takes 3 AdamW steps (clip 1.0, decay 0.1, warmup +
cosine) from the same flax params on 2 or 4 gloo ranks
(`torch_dist_worker.py`, one world per rank count, `torch.set_num_threads(1)`),
in one process of the port, and in the JAX package under the same mesh of
virtual CPU devices.  Losses agree within 5e-5 relative at every step and
parameters within 1e-4 absolute, the key biases aside (their gradient is
zero in exact arithmetic and Adam turns the rounding residue into steps of
up to lr: ROADMAP §C).  Under ZeRO each rank's moments hold 1/dp of every
sharded entry.  A checkpoint saved under {"dp": 2} + ZeRO resumes under
{"tp": 2} and the reverse, with the unbroken run's losses; the
`zero_plan-<step>.json` sidecar is written and pruned with its step.
Last, the workloads run as processes under tp, fsdp and ZeRO, and print
the JAX workloads' `zero_sharding_plan:` line byte for byte.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import resnet as JR
from tf_operator_tpu.models import transformer as J
from tf_operator_tpu.parallel.mesh import build_mesh as j_build_mesh
from tf_operator_tpu.parallel.tp_rules import combined_spec as j_combined
from tf_operator_tpu.parallel.tp_rules import make_param_shardings
from tf_operator_tpu.train import optim as joptim
from tf_operator_tpu.train import zero as jzero
from tf_operator_tpu.train.state import create_train_state as j_create
from tf_operator_tpu.train.step import lm_loss_fn as j_loss_fn
from tf_operator_tpu.train.step import make_train_step as j_make_step
from tf_operator_tpu.train.step import shard_batch as j_shard_batch
from tf_operator_tpu.train.step import shard_train_state
from tf_operator_tpu.workloads import runner as j_runner
from tf_operator_tpu_torch.models import resnet as R
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models.convert import params_from_flax
from tf_operator_tpu_torch.parallel.mesh import build_mesh
from tf_operator_tpu_torch.parallel.tp_rules import param_layouts
from tf_operator_tpu_torch.train import data as tdata
from tf_operator_tpu_torch.train import optim as toptim
from tf_operator_tpu_torch.train import zero as tzero
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
from tf_operator_tpu_torch.train.state import create_train_state
from tf_operator_tpu_torch.train.step import lm_loss_fn, make_train_step
from torch_dist_worker import World

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 5e-5
PARAM_ATOL = 1e-4

# ---------------------------------------------------------------------------
# layouts and plans at full width (no weights: meta tensors, eval_shape)

FULL = {"gpt": ("gpt_small_config", {}),
        "llama": ("llama_style_config", {})}  # 12 heads over 4 KV heads
LAYOUT_MESHES = [{"tp": 2}, {"fsdp": 2}, {"fsdp": 2, "tp": 2},
                 {"dp": 2, "tp": 2}]
PLAN_MESHES = [{"dp": 2}, {"dp": 4}, {"dp": 2, "tp": 2}]


def _jax_shapes(model, example, **kwargs):
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), example,
                                             **kwargs))["params"]


def _flat(tree):
    return {tuple(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _models(arch):
    preset, extra = FULL[arch]
    with torch.device("meta"):
        port = T.TransformerLM(getattr(T, preset)(**extra))
    shapes = _jax_shapes(J.TransformerLM(getattr(J, preset)(**extra)),
                         jnp.zeros((1, 8), jnp.int32))
    return port, shapes


def _mesh_pair(axes):
    n = int(np.prod(list(axes.values())))
    return build_mesh(axes, n), j_build_mesh(axes, devices=jax.devices()[:n])


@pytest.mark.parametrize("arch", list(FULL))
@pytest.mark.parametrize("axes", LAYOUT_MESHES,
                         ids=[json.dumps(a) for a in LAYOUT_MESHES])
def test_layout_maps_back_to_the_jax_combined_spec(arch, axes):
    port, shapes = _models(arch)
    mesh, jmesh = _mesh_pair(axes)
    want = {path: j_combined("/".join(path), leaf.shape, jmesh)
            for path, leaf in _flat(shapes).items()}
    layouts = param_layouts(port, mesh)
    assert {lay.path for lay in layouts.values()} == set(want)
    for lay in layouts.values():
        held = {axis: dim for axis, dim in (("tp", lay.tp_dim),
                                            ("fsdp", lay.fsdp_dim))
                if dim is not None}
        assert lay.flax_spec(held, mesh) == tuple(want[lay.path]), lay.name
        assert lay.spec == tuple(want[lay.path]), lay.name


SPEC_SHAPES = [(768,), (768, 3072), (3072, 768), (12, 64, 768),
               (768, 12, 64), (7, 7, 3, 64), (3, 5), (4, 4), ()]


@pytest.mark.parametrize("shape", SPEC_SHAPES,
                         ids=[str(s) for s in SPEC_SHAPES])
def test_spec_functions_are_the_jax_functions(shape):
    """`param_partition_spec` and `free_dim_partition_spec` (on every base
    the tp rules give), as tuples, equal the JAX functions' specs."""
    from tf_operator_tpu.parallel import mesh as jm
    from tf_operator_tpu_torch.parallel import mesh as tm

    for axes in ({"fsdp": 2}, {"fsdp": 4}, {"dp": 2, "tp": 2},
                 {"dp": 4, "tp": 2}):
        mesh, jmesh = _mesh_pair(axes)
        assert tm.param_partition_spec(shape, mesh) == \
            tuple(jm.param_partition_spec(shape, jmesh))
        for base in [()] + [tuple("tp" if i == d else None
                                  for i in range(d + 1))
                            for d in range(len(shape))]:
            got = tm.free_dim_partition_spec(shape, mesh, base=base)
            want = jm.free_dim_partition_spec(
                shape, jmesh, base=jax.sharding.PartitionSpec(*base))
            assert got == tuple(want), (axes, base)


def _plans(port, shapes, axes):
    mesh, jmesh = _mesh_pair(axes)
    jplan = jzero.build_zero_plan(
        shapes, jmesh, base_specs=make_param_shardings(shapes, jmesh))
    return tzero.plan_for_model(port, mesh), jplan


@pytest.mark.parametrize("arch", list(FULL))
@pytest.mark.parametrize("axes", PLAN_MESHES,
                         ids=[json.dumps(a) for a in PLAN_MESHES])
def test_zero_plan_json_is_the_jax_plan(arch, axes):
    port, shapes = _models(arch)
    ours, theirs = _plans(port, shapes, axes)
    assert ours.to_json() == theirs.to_json()
    back = tzero.ZeroShardingPlan.from_json(ours.to_json())
    assert back == ours and back.to_json() == ours.to_json()
    # the dense placement plan (no dp axis) as well
    mesh, jmesh = _mesh_pair(axes)
    base = tzero.base_placement_plan(
        [(e.path, e.shape) for e in ours.entries], mesh,
        base_specs=[e.base for e in ours.entries])
    jbase = jzero.base_placement_plan(
        shapes, jmesh, base_specs=make_param_shardings(shapes, jmesh))
    assert base.to_json() == jbase.to_json()


def test_resnet50_zero_plan_json_is_the_jax_plan():
    with torch.device("meta"):
        port = R.ResNet50(num_classes=1000)
    shapes = _jax_shapes(JR.ResNet50(num_classes=1000),
                         jnp.zeros((1, 224, 224, 3)), train=True)
    ours, theirs = _plans(port, shapes, {"dp": 2})
    assert ours.to_json() == theirs.to_json()


def test_opt_state_bytes_per_device_is_the_jax_figure():
    """GPT-small's moments per rank under a dp 8 plan: the figure the
    card's run prints as computed."""
    port, shapes = _models("gpt")
    ours, theirs = _plans(port, shapes, {"dp": 8})
    from tf_operator_tpu_torch.models.convert import flax_param_map

    params = [(e.path, e.shape) for e in flax_param_map(port)]
    got = tzero.opt_state_bytes_per_device(ours, params)
    assert got == jzero.opt_state_bytes_per_device(theirs, shapes)
    assert tzero.opt_state_bytes_per_device(None, params) == \
        jzero.opt_state_bytes_per_device(None, shapes)
    assert got < tzero.opt_state_bytes_per_device(None, params) / 7


def test_a_merged_head_dim_cannot_be_sharded():
    """ZeRO under fsdp puts dp on a query kernel's head_dim, which lies
    inside the port's [heads * head_dim]: no port dim holds it
    (`port_dim` says so), and the ZeRO slice is taken on the view that
    splits the merged dim in two."""
    port, _ = _models("gpt")
    mesh = build_mesh({"dp": 2, "fsdp": 2}, 4)
    plan = tzero.plan_for_model(port, mesh)
    lay = param_layouts(port, mesh, plan)["blocks.0.attn.query.weight"]
    with pytest.raises(ValueError, match="no single dim"):
        lay.port_dim(plan.match(lay.path, lay.flax_shape).dim)
    assert (lay.zero_dim, lay.zero_split) == (1, (0, 64))


# ---------------------------------------------------------------------------
# 3 AdamW steps over gloo ranks against one process and JAX

SMALL = dict(num_layers=2, d_model=128, num_heads=2, vocab_size=256,
             max_len=32)
ARCHS = {"gpt": ("gpt_small_config", dict(d_ff=256)),
         "llama": ("llama_style_config", dict(num_kv_heads=2, d_ff=192))}
OPT = dict(schedule="cosine", warmup_steps=1, total_steps=5,
           weight_decay=0.1, grad_clip=1.0)
LR = 3e-3
# name -> (mesh, arch, zero)
CASES = {f"{'_'.join(f'{k}{v}' for k, v in axes.items())}_{arch}":
         (axes, arch, False)
         for axes in ({"tp": 2}, {"fsdp": 2}, {"dp": 2, "tp": 2},
                      {"fsdp": 2, "tp": 2})
         for arch in ARCHS}
CASES.update({f"{'_'.join(f'{k}{v}' for k, v in axes.items())}_zero_{arch}":
              (axes, arch, True)
              for axes in ({"dp": 2}, {"dp": 2, "tp": 2}) for arch in ARCHS})
CASES["tp2_sp2_llama"] = ({"tp": 2, "sp": 2}, "llama", False)
# save after 2 steps under the first layout, resume the third under the
# second: (first mesh, zero), (second mesh, zero)
RESUMES = {"dp2_zero_to_tp2": (({"dp": 2}, True), ({"tp": 2}, False)),
           "tp2_to_dp2_zero": (({"tp": 2}, False), ({"dp": 2}, True))}


def batches():
    return [b["tokens"] for b, _ in
            zip(tdata.synthetic_tokens(8, 33, 256, seed=1), range(3))]


def _flax_init(arch):
    preset, extra = ARCHS[arch]
    cfg = getattr(J, preset)(dtype=jnp.float32, **SMALL, **extra)
    return jax.device_get(J.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32))["params"])


def jax_run(axes, arch, zero, init):
    """The JAX LM's losses and params (port layout) under the mesh."""
    n = int(np.prod(list(axes.values())))
    mesh = j_build_mesh(axes, devices=jax.devices()[:n])
    preset, extra = ARCHS[arch]
    model = J.TransformerLM(getattr(J, preset)(
        dtype=jnp.float32, mesh=mesh, ring_axis="sp", **SMALL, **extra))
    plan = None
    if zero:
        plan = jzero.build_zero_plan(
            init, mesh, base_specs=make_param_shardings(init, mesh))
    tx = joptim.lm_optimizer(LR, **OPT, zero_plan=plan,
                             mesh=mesh if zero else None)
    plain = J.TransformerLM(getattr(J, preset)(dtype=jnp.float32, **SMALL,
                                               **extra))
    state = j_create(jax.random.PRNGKey(0), plain, tx,
                     jnp.zeros((2, 32), jnp.int32), zero_plan=plan)
    state = shard_train_state(state.replace(params=init), mesh,
                              zero_plan=plan)
    step = j_make_step(j_loss_fn(model.apply), donate=False)
    losses = []
    for tokens in batches():
        state, metrics = step(state, j_shard_batch({"tokens": tokens}, mesh))
        losses.append(float(metrics["loss"]))
    return losses, params_from_flax(jax.device_get(state.params))


def port_run(arch, init):
    preset, extra = ARCHS[arch]
    model = T.TransformerLM(getattr(T, preset)(dtype=torch.float32, **SMALL,
                                               **extra))
    model.load_state_dict(init)
    state = create_train_state(model, toptim.lm_optimizer(LR, **OPT),
                               seed=None)
    step = make_train_step(lm_loss_fn(model))
    losses = []
    for tokens in batches():
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(metrics["loss"]))
    return losses, model.state_dict()


def _job(name, axes, arch, zero, init, **extra):
    preset, config = ARCHS[arch]
    return dict(name=name, mesh=axes, preset=preset,
                config=dict(dtype=torch.float32, **SMALL, **config),
                init=init, opt=dict(peak_lr=LR, **OPT), zero=zero,
                batches=[torch.from_numpy(b) for b in batches()], **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's results per case, one world per rank count started
    first; meanwhile the one-process port's and JAX's."""
    flax = {arch: _flax_init(arch) for arch in ARCHS}
    init = {arch: params_from_flax(flax[arch]) for arch in ARCHS}
    jobs = {2: [], 4: []}
    for name, (axes, arch, zero) in CASES.items():
        jobs[int(np.prod(list(axes.values())))].append(
            _job(name, axes, arch, zero, init[arch]))
    ckpt = tmp_path_factory.mktemp("ckpt")
    for name, ((first, z1), (second, z2)) in RESUMES.items():
        jobs[2].append(_job(name, first, "gpt", z1, init["gpt"],
                            resume={"mesh": second, "zero": z2},
                            resume_at=2, ckpt=str(ckpt / name)))
    worlds = {n: World(tmp_path_factory.mktemp(f"world{n}"), n,
                       dict(kind="shard", cases=cases))
              for n, cases in jobs.items()}
    out = {"port": {arch: port_run(arch, init[arch]) for arch in ARCHS},
           "jax": {name: jax_run(axes, arch, zero, flax[arch])
                   for name, (axes, arch, zero) in CASES.items()},
           "init": init, "ranks": {}}
    for n, world in worlds.items():
        results = world.results(timeout=300)
        for case in jobs[n]:
            out["ranks"][case["name"]] = [r[case["name"]] for r in results]
    return out


def _close(got_losses, got_params, want, init):
    losses, params = want
    np.testing.assert_allclose(got_losses, losses, rtol=LOSS_RTOL, atol=0)
    moved = 0.0
    for key, value in params.items():
        if key.endswith("key.bias"):
            continue
        torch.testing.assert_close(got_params[key], value, atol=PARAM_ATOL,
                                   rtol=0, msg=key)
        moved = max(moved, float((value - init[key]).abs().max()))
    assert moved > 10 * PARAM_ATOL  # the steps moved the parameters


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_match_one_process_and_jax(runs, name, against):
    axes, arch, _ = CASES[name]
    want = (runs["port"][arch] if against == "one_process"
            else runs["jax"][name])
    for rank in runs["ranks"][name]:
        _close(rank["losses"].numpy(), rank["params"], want,
               runs["init"][arch])


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_piece(runs, name):
    """Every rank's parameters and moments are its layout's share of the
    whole: under ZeRO, 1/dp of every entry the plan shards; and the
    layout it holds is the JAX spec."""
    axes, arch, zero = CASES[name]
    preset, extra = ARCHS[arch]
    mesh = build_mesh(axes, int(np.prod(list(axes.values()))))
    with torch.device("meta"):
        model = T.TransformerLM(getattr(T, preset)(**SMALL, **extra))
    plan = tzero.plan_for_model(model, mesh) if zero else None
    layouts = param_layouts(model, mesh, plan)
    full = {n: p.numel() for n, p in model.named_parameters()}
    sharded = 0
    for rank in runs["ranks"][name]:
        for n, lay in layouts.items():
            split = 1
            for axis, dim in (("tp", lay.tp_dim), ("fsdp", lay.fsdp_dim)):
                if dim is not None:
                    split *= axes[axis]
            assert int(rank["local_params"][n]) == full[n] // split, n
            if lay.zero_dim is not None:
                split *= axes["dp"]
                sharded += 1
            assert int(rank["local_moments"][n]) == full[n] // split, n
            assert rank["held"][n] == lay.spec, n
    assert (sharded > 0) == zero


@pytest.mark.parametrize("name", list(RESUMES))
def test_checkpoint_resumes_under_another_mesh(runs, name):
    (_, zero_first), _ = RESUMES[name]
    for rank in runs["ranks"][name]:
        assert int(rank["restored_step"]) == 2
        _close(rank["losses"].numpy(), rank["params"], runs["port"]["gpt"],
               runs["init"]["gpt"])
        assert ("zero_plan-2.json" in rank["files"]) == zero_first
        assert "2" in rank["files"]


def test_zero_plan_sidecar_is_pruned_with_its_step(tmp_path):
    """One process holding a plan (built for a dp 2 layout): each save
    writes zero_plan-<step>.json beside its step, max_to_keep prunes both,
    and saved_zero_plan reads the newest back."""
    model = T.TransformerLM(T.gpt_small_config(dtype=torch.float32, **SMALL,
                                               d_ff=256))
    state = create_train_state(model, toptim.lm_optimizer(LR, **OPT))
    state.zero_plan = tzero.plan_for_model(model, build_mesh({"dp": 2}, 2))
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    for step in (1, 2):
        state.step = step
        mgr.save(state)
    mgr.close()
    names = sorted(os.listdir(tmp_path))
    assert names == ["2", "zero_plan-2.json"]
    assert mgr.saved_zero_plan() == state.zero_plan


# ---------------------------------------------------------------------------
# the workloads as processes

TINY_LM = ["--steps", "2", "--batch", "4", "--seq-len", "16", "--vocab",
           "64", "--layers", "1", "--d-model", "128"]
TINY_RESNET = ["--steps", "2", "--depth", "18", "--batch", "4",
               "--image-size", "32", "--num-classes", "10", "--log-every",
               "1"]
WORKLOAD_RUNS = {
    "lm_dp2_zero": ("lm", {"dp": 2}, True, TINY_LM),
    "lm_tp2": ("lm", {"tp": 2}, False, TINY_LM),
    "lm_fsdp2": ("lm", {"fsdp": 2}, False, TINY_LM),
    "resnet_dp2_zero": ("resnet", {"dp": 2}, True, TINY_RESNET),
}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def workload_logs():
    """Every run's processes, started at once; rank 0's log per run."""
    procs = {}
    for name, (module, axes, zero, args) in WORKLOAD_RUNS.items():
        address = f"127.0.0.1:{_free_port()}"
        procs[name] = []
        for rank in range(2):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("TPUJOB_") and k != "TF_CONFIG"}
            env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                       TPUJOB_FORCE_PLATFORM="cpu",
                       TPUJOB_NUM_PROCESSES="2", TPUJOB_PROCESS_ID=str(rank),
                       TPUJOB_COORDINATOR_ADDRESS=address,
                       TPUJOB_MESH_SHAPE=json.dumps(axes))
            if zero:
                env["TPUJOB_ZERO_SHARD_WEIGHT_UPDATE"] = "1"
            procs[name].append(subprocess.Popen(
                [sys.executable, "-m",
                 f"tf_operator_tpu_torch.workloads.{module}", *args],
                cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    logs = {}
    try:
        for name, ranks in procs.items():
            outs = [p.communicate(timeout=240)[0] for p in ranks]
            assert all(p.returncode == 0 for p in ranks), "\n".join(outs)
            logs[name] = outs
    finally:
        for ranks in procs.values():
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return logs


def _plan_line(text):
    lines = [ln for ln in text.splitlines()
             if ln.startswith("zero_sharding_plan: ")]
    assert len(lines) == 1, text
    return lines[0]


def _jax_plan_line(capsys, model, example, axes, **kwargs):
    mesh = j_build_mesh(axes, devices=jax.devices()[:2])
    ctx = j_runner.WorkloadContext(zero_shard_weight_update=True)
    capsys.readouterr()
    j_runner.zero_plan_for_workload(ctx, model, example, mesh, **kwargs)
    return _plan_line(capsys.readouterr().out)


def test_lm_workload_prints_the_jax_zero_plan_line(workload_logs, capsys):
    """The JAX LM workload's model for the same flags: heads d_model/64,
    d_ff 4 d_model, max_len the sequence length."""
    model = J.TransformerLM(J.TransformerConfig(
        vocab_size=64, num_layers=1, num_heads=2, d_model=128, d_ff=512,
        max_len=16))
    want = _jax_plan_line(capsys, model, jnp.zeros((2, 16), jnp.int32),
                          {"dp": 2})
    for log in workload_logs["lm_dp2_zero"]:  # every rank prints it
        assert _plan_line(log) == want


def test_resnet_workload_prints_the_jax_zero_plan_line(workload_logs,
                                                       capsys):
    want = _jax_plan_line(capsys, JR.ResNet18(num_classes=10),
                          jnp.zeros((2, 32, 32, 3)), {"dp": 2},
                          init_kwargs={"train": True})
    assert _plan_line(workload_logs["resnet_dp2_zero"][0]) == want
    assert "done: 2 steps" in workload_logs["resnet_dp2_zero"][0]


def _losses(log):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step (\d+) loss (\S+)$", log, re.M)}


def test_lm_workload_trains_under_tp_fsdp_and_zero(workload_logs):
    """The same model and stream under each layout: the same first loss
    (within 1e-2: the workload computes in bf16, and tp sums its partial
    products in another order) and one `done` from rank 0 alone."""
    first = {name: _losses(workload_logs[name][0])
             for name in ("lm_dp2_zero", "lm_tp2", "lm_fsdp2")}
    for losses in first.values():
        assert list(losses) == [0]
        assert abs(losses[0] - first["lm_dp2_zero"][0]) <= 1e-2
    for name in first:
        rank0, rank1 = workload_logs[name]
        assert rank0.count("done") == 1 and "done" not in rank1
