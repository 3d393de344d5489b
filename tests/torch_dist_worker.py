"""One rank of a multi-process gloo world for the port's parallel tests.

The tests (`tests/test_torch_parallel.py`, `tests/test_torch_dist_lm.py`,
`tests/test_torch_classify_dist.py`, `tests/test_torch_pipeline.py`,
`tests/test_torch_encoder_parallel.py` and others) write a job file, start `world` processes of this script and read
back one result file per rank.  The ranks import the port and torch only
(never JAX), join one group through a `file://` store, and run every case
of the job in that one world, so a test file pays for its world's start
once.

    python tests/torch_dist_worker.py JOB RANK WORLD STORE OUT_DIR

A job is {"kind": "attention" | "lm" | "classify" | "shard" | "decode" |
"pipeline" | "encoder", "cases": [...]}, saved with torch.save (a case's
own "kind" overrides the job's); each case's result goes into the rank's
result file under the case's name.

    python tests/torch_dist_worker.py workload NAME NATIVE ARGS...

runs one pod of a workload's main (its process group from the TPUJob env;
as many ranks as the pod launcher gives it) with every rank printing its
own loss and digests of its batch and its parameters after each step
(`run_workload`; `launch_workload` starts it, `replica_steps` reads it
back), and

    python tests/torch_dist_worker.py standin OUT_DIR ACTION...

is the launcher's stand-in child (`standin`).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


class World:
    """`world` ranks of this script running `job`, started at once; the
    caller may work meanwhile and then collect the results."""

    def __init__(self, tmp_path: Path, world: int, job: dict) -> None:
        self.tmp_path, self.world = tmp_path, world
        job_file = tmp_path / "job.pt"
        torch.save(job, job_file)
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, str(job_file), str(rank), str(world),
             str(tmp_path / "store"), str(tmp_path)],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in range(world)]

    def results(self, timeout: float = 120.0) -> list:
        """Each rank's results; raises with the ranks' output if any rank
        fails, and kills every rank still running."""
        logs = []
        try:
            for proc in self.procs:
                logs.append(proc.communicate(timeout=timeout)[0])
        finally:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if any(proc.returncode for proc in self.procs):
            raise RuntimeError("a rank failed:\n" + "\n".join(
                f"--- rank {r} (exit {p.returncode})\n{log}"
                for r, (p, log) in enumerate(zip(self.procs, logs))))
        return [torch.load(self.tmp_path / f"out_{rank}.pt",
                           weights_only=True) for rank in range(self.world)]


def _shard(x, mesh, axis="sp", dim=2):
    """This rank's contiguous slice of dim `dim` over mesh axis `axis`."""
    n = mesh.shape.get(axis, 1)
    t = x.shape[dim] // n
    return x.narrow(dim, mesh.coordinate(axis) * t, t).contiguous()


def attention_case(case: dict) -> dict:
    from tf_operator_tpu_torch.parallel.mesh import build_mesh
    from tf_operator_tpu_torch.parallel.ring_attention import ring_attention
    from tf_operator_tpu_torch.parallel.ulysses import ulysses_attention

    world = torch.distributed.get_world_size()
    sp = case["sp"]
    mesh = build_mesh({"dp": world // sp, "sp": sp}, device_type="cpu")
    group = mesh.group("sp")
    attend = (ulysses_attention if case["strategy"] == "ulysses"
              else ring_attention)
    q, k, v = (_shard(case[x], mesh).requires_grad_() for x in "qkv")
    if case.get("expect_error"):
        try:
            attend(q, k, v, group, causal=case["causal"])
        except ValueError as e:
            return {"error": str(e)}
        raise AssertionError("no error")
    out = attend(q, k, v, group, causal=case["causal"],
                 use_flash=case["use_flash"])
    out.backward(_shard(case["g"], mesh))
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
            "sp_index": torch.tensor(mesh.coordinate("sp"))}


def lm_case(case: dict) -> dict:
    import dataclasses

    from tf_operator_tpu_torch.models import transformer as T
    from tf_operator_tpu_torch.parallel.mesh import build_mesh
    from tf_operator_tpu_torch.train import optim
    from tf_operator_tpu_torch.train.state import create_train_state
    from tf_operator_tpu_torch.train.step import (lm_loss_fn, make_train_step,
                                                  shard_batch)

    mesh = build_mesh(case["mesh"], device_type="cpu")
    cfg = getattr(T, case["preset"])(**case["config"])
    cfg = dataclasses.replace(cfg, mesh=mesh,
                              seq_parallel=case["seq_parallel"])
    model = T.TransformerLM(cfg)
    model.load_state_dict(case["init"])
    state = create_train_state(model, optim.lm_optimizer(**case["opt"]),
                               seed=None, mesh=mesh)
    step = make_train_step(lm_loss_fn(model), grad_accum=case["grad_accum"],
                           mesh=mesh)
    losses = []
    for tokens in case["batches"]:
        state, metrics = step(state, shard_batch({"tokens": tokens},
                                                 state.sharding,
                                                 case["grad_accum"]))
        losses.append(float(metrics["loss"]))
    return {"losses": torch.tensor(losses, dtype=torch.float64),
            "params": model.state_dict()}


def classify_case(case: dict) -> dict:
    """ResNet18 (SGD) or ViT (adamw) steps over the case's mesh (default: dp
    over every rank; fsdp, and ZeRO over dp with `zero`), each rank on its
    rows of the global batches (with `grad_accum`, its rows of each
    microbatch); `per_rank_bn` builds the ResNet's BatchNorms without the
    data group (a planted fault).  With `eval_batch`, the eval step's
    metrics on it after the steps."""
    from tf_operator_tpu_torch.models import resnet, vit
    from tf_operator_tpu_torch.parallel.mesh import build_mesh, data_axes
    from tf_operator_tpu_torch.train import optim
    from tf_operator_tpu_torch.train.state import create_train_state
    from tf_operator_tpu_torch.train.step import (classification_loss_fn,
                                                  classification_metrics,
                                                  make_eval_step,
                                                  make_train_step,
                                                  shard_batch)
    from tf_operator_tpu_torch.train.zero import plan_for_model

    world = torch.distributed.get_world_size()
    mesh = build_mesh(case.get("mesh", {"dp": world}), device_type="cpu")
    accum = case.get("grad_accum", 1)
    if case["model"] == "resnet18":
        group = None
        if not case.get("per_rank_bn"):
            group = mesh.group_over(data_axes(mesh)) or \
                torch.distributed.group.WORLD
        model = resnet.ResNet18(num_classes=10, dtype=torch.float32,
                                bn_group=group)
        recipe = optim.sgd(case["lr"])
    else:
        model = vit.ViT(vit.vit_base_config(dtype=torch.float32,
                                            **case["config"]),
                        num_classes=10, patch_size=4, image_size=16)
        recipe = optim.adamw(case["lr"])
    model.load_state_dict(case["init"])
    plan = plan_for_model(model, mesh) if case.get("zero") else None
    state = create_train_state(model, recipe, seed=None, mesh=mesh,
                               zero_plan=plan)
    step = make_train_step(classification_loss_fn(model), grad_accum=accum,
                           mesh=mesh)
    losses = []
    for batch in case["batches"]:
        state, metrics = step(state, shard_batch(batch, state.sharding, accum))
        losses.append(float(metrics["loss"]))
    out = {"losses": torch.tensor(losses, dtype=torch.float64),
           "state": full_state_dict(state)}
    if "eval_batch" in case:
        metrics = make_eval_step(classification_metrics(model), mesh)(
            state, shard_batch(case["eval_batch"], state.sharding))
        out["eval"] = {k: v.double() for k, v in metrics.items()}
    return out


def full_state_dict(state):
    """The whole parameters and buffers of a (possibly sharded) state."""
    from tf_operator_tpu_torch.train.state import full_state

    return full_state(state)["model"]


def _lm_state(case, axes, zero):
    """A TransformerLM from the case's whole parameters, laid out on the
    mesh `axes` (over every rank), with the ZeRO plan when `zero`."""
    import dataclasses

    from tf_operator_tpu_torch.models import transformer as T
    from tf_operator_tpu_torch.parallel.mesh import build_mesh
    from tf_operator_tpu_torch.train import optim
    from tf_operator_tpu_torch.train.state import create_train_state
    from tf_operator_tpu_torch.train.zero import plan_for_model

    mesh = build_mesh(axes, device_type="cpu")
    cfg = getattr(T, case["preset"])(**case["config"])
    cfg = dataclasses.replace(cfg, mesh=mesh,
                              seq_parallel=case.get("seq_parallel", "ring"))
    model = T.TransformerLM(cfg)
    model.load_state_dict(case["init"])
    plan = plan_for_model(model, mesh) if zero else None
    state = create_train_state(model, optim.lm_optimizer(**case["opt"]),
                               seed=None, mesh=mesh, zero_plan=plan)
    return mesh, state


def shard_case(case: dict) -> dict:
    """The LM over a mesh with tp, ep, fsdp or ZeRO: AdamW steps on the
    global batches (with `moe_aux_weight`, the MoE load-balancing loss
    added and its metric kept), the whole parameters gathered after them,
    each rank's parameter and moment sizes, and the specs the ranks hold.
    With `resume` (a second mesh) the first `resume_at` steps run on the
    case's mesh and save a checkpoint, and the rest restore it on the
    second.  `local_routing` routes each rank's tokens alone (a planted
    fault: the MoE layers forget the groups that split the batch)."""
    from tf_operator_tpu_torch.parallel.moe import MoEMLP
    from tf_operator_tpu_torch.parallel.shard import local
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.state import full_state
    from tf_operator_tpu_torch.train.step import (lm_loss_fn, make_train_step,
                                                  shard_batch)

    accum = case.get("grad_accum", 1)
    mesh, state = _lm_state(case, case["mesh"], case.get("zero", False))
    if case.get("local_routing"):
        for module in state.model.modules():
            if isinstance(module, MoEMLP):
                module.token_groups = ()
    out = {"held": state.sharding.held_specs()}
    losses, aux = [], []
    for i, tokens in enumerate(case["batches"]):
        if case.get("resume") and i == case["resume_at"]:
            mgr = CheckpointManager(case["ckpt"])
            mgr.save(state)
            mgr.close()
            out["files"] = sorted(os.listdir(case["ckpt"]))
            mesh, state = _lm_state(case, case["resume"]["mesh"],
                                    case["resume"].get("zero", False))
            mgr = CheckpointManager(case["ckpt"])
            mgr.restore(state)
            mgr.close()
            out["restored_step"] = torch.tensor(state.step)
        step = make_train_step(
            lm_loss_fn(state.model,
                       moe_aux_weight=case.get("moe_aux_weight", 0.0),
                       loss_chunk=case.get("loss_chunk", 0)),
            grad_accum=accum, mesh=mesh)
        state, metrics = step(state, shard_batch({"tokens": tokens},
                                                 state.sharding,
                                                 accum))
        losses.append(float(metrics["loss"]))
        if "moe_aux_loss" in metrics:
            aux.append(float(metrics["moe_aux_loss"]))
    full = full_state(state)
    out.update(
        losses=torch.tensor(losses, dtype=torch.float64),
        aux=torch.tensor(aux, dtype=torch.float64),
        params=full["model"],
        local_params={n: torch.tensor(local(p).numel())
                      for n, p in state.model.named_parameters()},
        local_moments={n: torch.tensor(local(state.optimizer.state[t][
            "exp_avg"]).numel()) for n, t in state.sharding.opt_named()})
    return out


def _encoder_state(case, axes, zero):
    """ViT or BERT ("model") from the case's whole parameters, laid out on
    the mesh `axes` (over every rank), with the ZeRO plan when `zero`; its
    optimizer adamw (with `sgd`, SGD at momentum 0.9)."""
    import dataclasses

    from tf_operator_tpu_torch.models import transformer as T
    from tf_operator_tpu_torch.models import vit as V
    from tf_operator_tpu_torch.parallel.mesh import build_mesh
    from tf_operator_tpu_torch.train import optim
    from tf_operator_tpu_torch.train.state import create_train_state
    from tf_operator_tpu_torch.train.zero import plan_for_model

    mesh = build_mesh(axes, device_type="cpu")
    if case["model"] == "vit":
        cfg = V.vit_base_config(dtype=torch.float32, **case["config"])
        model = V.ViT(dataclasses.replace(cfg, mesh=mesh), **case["build"])
    else:
        cfg = T.bert_base_config(dtype=torch.float32, **case["config"])
        model = T.BertEncoder(dataclasses.replace(cfg, mesh=mesh),
                              **case["build"])
    model.load_state_dict(case["init"])
    plan = plan_for_model(model, mesh) if zero else None
    recipe = (optim.sgd(case["lr"]) if case.get("sgd")
              else optim.adamw(case["lr"]))
    return mesh, create_train_state(model, recipe, seed=None, mesh=mesh,
                                    zero_plan=plan)


def encoder_case(case: dict) -> dict:
    """ViT or BERT over the case's mesh (tp, sp, fsdp, and ZeRO over dp
    with `zero`): steps on the global batches (with `grad_accum`), the
    losses, the whole parameters gathered after them, each rank's
    parameter and moment sizes, the specs the ranks hold, the entries
    whose ZeRO slice is taken on a split head_dim and the sequence length
    the first block saw; with `ckpt`, the state saved there after the
    steps, and with `resume` (a second mesh and zero) that checkpoint
    restored under it and one more step taken on `resume_batch`."""
    from tf_operator_tpu_torch.parallel.shard import local
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.state import full_state
    from tf_operator_tpu_torch.train.step import (classification_loss_fn,
                                                  make_train_step,
                                                  shard_batch)

    accum = case.get("grad_accum", 1)
    mesh, state = _encoder_state(case, case["mesh"], case.get("zero"))
    model = state.model
    moment = "momentum_buffer" if case.get("sgd") else "exp_avg"
    seen = []
    model.blocks[0].register_forward_pre_hook(
        lambda _, args: seen.append(args[0].shape[1]))
    step = make_train_step(classification_loss_fn(model), grad_accum=accum,
                           mesh=mesh)
    losses = []
    for batch in case["batches"]:
        state, metrics = step(state, shard_batch(batch, state.sharding,
                                                 accum))
        losses.append(float(metrics["loss"]))
    out = {"losses": torch.tensor(losses, dtype=torch.float64),
           "params": full_state(state)["model"],
           "held": state.sharding.held_specs(),
           "split": sorted(state.sharding.zero_splits),
           "seq": torch.tensor(seen[0]),
           "local_params": {n: torch.tensor(local(p).numel())
                            for n, p in model.named_parameters()},
           "local_moments": {n: torch.tensor(local(state.optimizer.state[t][
               moment]).numel()) for n, t in state.sharding.opt_named()}}
    if case.get("ckpt"):
        mgr = CheckpointManager(case["ckpt"])
        mgr.save(state)
        mgr.close()
    if case.get("resume"):
        mesh, state = _encoder_state(case, case["resume"]["mesh"],
                                     case["resume"]["zero"])
        mgr = CheckpointManager(case["ckpt"])
        mgr.restore(state)
        mgr.close()
        step = make_train_step(classification_loss_fn(state.model),
                               mesh=mesh)
        state, metrics = step(state, shard_batch(case["resume_batch"],
                                                 state.sharding))
        out.update(restored_step=torch.tensor(state.step - 1),
                   resumed_loss=torch.tensor(float(metrics["loss"]),
                                             dtype=torch.float64),
                   resumed_params=full_state(state)["model"])
    return out


def decode_case(case: dict) -> dict:
    """Greedy (or, with `temperature` and `seed`, sampled) generation from
    the case's whole parameters laid out on its mesh (tp: each rank's
    heads, its KV heads in the cache, its vocab slice of the logits)."""
    import dataclasses

    from tf_operator_tpu_torch.models import transformer as T
    from tf_operator_tpu_torch.models.generate import generate
    from tf_operator_tpu_torch.parallel.mesh import build_mesh
    from tf_operator_tpu_torch.parallel.shard import Sharding

    mesh = build_mesh(case["mesh"], device_type="cpu")
    cfg = dataclasses.replace(getattr(T, case["preset"])(**case["config"]),
                              mesh=mesh)
    model = T.TransformerLM(cfg)
    model.load_state_dict(case["init"])
    Sharding(model, mesh)
    generator = None
    if case.get("seed") is not None:
        generator = torch.Generator().manual_seed(case["seed"])
    tokens = generate(model, case["prompt"], case["new_tokens"],
                      temperature=case.get("temperature", 0.0),
                      top_k=case.get("top_k", 0), generator=generator)
    cache = model.init_cache(case["prompt"].shape[0])
    return {"tokens": tokens,
            "cache_shape": torch.tensor(cache.layers[0].cached_key.shape)}


def pipeline_case(case: dict) -> dict:
    """The pipelined LM over the case's mesh (its pp group; dp lines
    replicate), this rank's stage from the JAX params: the logits, then per
    schedule in `schedules` the loss and every gradient this rank holds,
    then `sgd_steps` SGD steps (lr `lr`) through `sgd_schedule` with their
    losses."""
    from tf_operator_tpu_torch.models import transformer as T
    from tf_operator_tpu_torch.models.convert import pipeline_from_flax
    from tf_operator_tpu_torch.models.pipeline_lm import \
        PipelinedTransformerLM
    from tf_operator_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(case["mesh"], device_type="cpu")
    virtual = case.get("virtual", 1)
    model = PipelinedTransformerLM(
        getattr(T, case["preset"])(**case["config"]), mesh,
        num_microbatches=case["microbatches"], virtual_stages=virtual)
    model.load_state_dict(pipeline_from_flax(
        case["params"], model.rank, model.num_stages, virtual))
    tokens = case["tokens"]
    out = {"pp": torch.tensor(model.rank),
           "dp": torch.tensor(mesh.coordinate("dp"))}
    with torch.no_grad():
        out["logits"] = model.apply(tokens)
    for schedule in case["schedules"]:
        model.zero_grad(set_to_none=True)
        loss = getattr(model, f"loss_{schedule}")(tokens)
        loss.backward()
        out[schedule] = {"loss": loss.detach(), "grads": {
            n: p.grad.clone() for n, p in model.named_parameters()}}
    losses = []
    for _ in range(case.get("sgd_steps", 0)):
        model.zero_grad(set_to_none=True)
        loss = getattr(model, f"loss_{case['sgd_schedule']}")(tokens)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= case["lr"] * p.grad
        losses.append(float(loss))
    out["sgd"] = torch.tensor(losses, dtype=torch.float64)
    return out


REPLICA_LINE = re.compile(r"^replica (\d+) step (\d+) loss (\S+) batch (\w+) "
                          r"params (\w+)$", re.M)


def run_workload(name: str, native: str, argv) -> int:
    """Workload `name`'s main on `argv`, every rank printing after each step
    `replica RANK step I loss L batch B params P`: its own loss and digests
    of the batch the step took and of the parameters after its update (the
    workloads log from rank 0 alone), so a test can hold the ranks that
    replicate a step to each other.  `native` "0" turns the native image
    loader off (its threads hand batches over in no fixed order)."""
    import hashlib
    import importlib

    import torch.distributed as dist

    from tf_operator_tpu_torch.train import native_data
    from tf_operator_tpu_torch.train import step as S

    if native == "0":
        native_data.native_available = lambda: False
    made = S.make_train_step

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(torch.as_tensor(t).detach().float().cpu().numpy()
                     .tobytes())
        return h.hexdigest()[:16]

    def make(*args, **kwargs):
        inner, taken = made(*args, **kwargs), []

        def step(state, batch):
            seen = digest(batch[k] for k in sorted(batch))
            state, metrics = inner(state, batch)
            rank = dist.get_rank() if dist.is_initialized() else 0
            # one write: the ranks of a pod share its stdout
            sys.stdout.write(
                f"replica {rank} step {len(taken)} loss "
                f"{float(metrics['loss'])!r} batch {seen} params "
                f"{digest(state.model.parameters())}\n")
            sys.stdout.flush()
            taken.append(seen)
            return state, metrics

        return step

    S.make_train_step = make
    return importlib.import_module(
        f"tf_operator_tpu_torch.workloads.{name}").main(list(argv))


def launch_workload(name: str, argv, env: dict, native: bool = True):
    """A process of `run_workload` (stdout and stderr as one text pipe)."""
    return subprocess.Popen(
        [sys.executable, __file__, "workload", name, "1" if native else "0",
         *argv], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def replica_steps(log: str) -> list:
    """[(step, loss, batch digest, params digest)] of a `run_workload` log,
    with the rank it names checked to be one rank throughout."""
    lines = REPLICA_LINE.findall(log)
    assert len({rank for rank, *_ in lines}) == 1, log
    return [tuple(rest) for _, *rest in lines]


def main(job_file, rank, world, store, out_dir) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    job = torch.load(job_file, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=int(rank), world_size=int(world))
    try:
        run = {"attention": attention_case, "lm": lm_case,
               "classify": classify_case, "shard": shard_case,
               "decode": decode_case, "pipeline": pipeline_case,
               "encoder": encoder_case}
        results = {case["name"]: run[case.get("kind", job["kind"])](case)
                   for case in job["cases"]}
        torch.save(results, Path(out_dir) / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


def standin(out_dir: str, *actions: str) -> int:
    """The pod launcher's stand-in child (`tests/test_torch_launch.py`):
    local rank i writes its pid to OUT_DIR/pid-<i>, then does actions[i]:
    `sleep` (until a signal ends it), `exit:N` (after the other ranks'
    pid files are there), `kill:N` (signal N to itself, likewise; it
    holds OUT_DIR/lock until it dies), `follow:N` (exit N the moment a
    `kill` rank dies, as a gloo rank fails when its peer's socket closes)
    or `ok` (exit 0)."""
    import fcntl
    import time

    rank = int(os.environ["LOCAL_RANK"])
    out = Path(out_dir)
    kind, _, arg = actions[rank].partition(":")
    if kind == "kill":
        lock = open(out / "lock", "w")
        fcntl.flock(lock, fcntl.LOCK_EX)
    (out / f".pid-{rank}").write_text(str(os.getpid()))
    (out / f".pid-{rank}").rename(out / f"pid-{rank}")
    if kind in ("exit", "kill", "follow"):
        deadline = time.monotonic() + 60
        while len(list(out.glob("pid-*"))) < len(actions):
            if time.monotonic() > deadline:
                raise TimeoutError("the other ranks' pid files never came")
            time.sleep(0.01)
    if kind == "sleep":
        time.sleep(600)
        return 1
    if kind == "exit":
        return int(arg)
    if kind == "kill":
        os.kill(os.getpid(), int(arg))
        time.sleep(600)
    if kind == "follow":
        with open(out / "lock") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
        os._exit(int(arg))
    return 0


if __name__ == "__main__":
    from tf_operator_tpu_torch.workloads.launch import run_pod

    if sys.argv[1] == "workload":
        name, native = sys.argv[2], sys.argv[3]
        sys.exit(run_pod(lambda argv: run_workload(name, native, argv),
                         sys.argv[4:]))
    if sys.argv[1] == "standin":
        sys.exit(run_pod(lambda argv: standin(*argv), sys.argv[2:]))
    main(*sys.argv[1:])
