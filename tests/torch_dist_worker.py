"""One rank of a multi-process gloo world for the port's parallel tests.

The tests (`tests/test_torch_parallel.py`, `tests/test_torch_dist_lm.py`,
`tests/test_torch_classify_dist.py`) write a job file, start `world` processes of this script and read back one
result file per rank.  The ranks import the port and torch only (never JAX),
join one group through a `file://` store, and run every case of the job in
that one world, so a test file pays for its world's start once.

    python tests/torch_dist_worker.py JOB RANK WORLD STORE OUT_DIR

A job is {"kind": "attention" | "lm" | "classify", "cases": [...]}, saved with
torch.save; each case's result goes into the rank's result file under the
case's name.
"""
from __future__ import annotations

import os
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
                               seed=None)
    step = make_train_step(lm_loss_fn(model), grad_accum=case["grad_accum"],
                           mesh=mesh)
    losses = []
    for tokens in case["batches"]:
        state, metrics = step(state, shard_batch({"tokens": tokens}, mesh))
        losses.append(float(metrics["loss"]))
    return {"losses": torch.tensor(losses, dtype=torch.float64),
            "params": model.state_dict()}


def classify_case(case: dict) -> dict:
    """ResNet18 (SGD) or ViT (adamw) steps over a dp mesh of every rank, each
    rank on its rows of the global batches; `per_rank_bn` builds the
    ResNet's BatchNorms without the dp group (a planted fault)."""
    from tf_operator_tpu_torch.models import resnet, vit
    from tf_operator_tpu_torch.parallel.mesh import build_mesh
    from tf_operator_tpu_torch.train import optim
    from tf_operator_tpu_torch.train.state import create_train_state
    from tf_operator_tpu_torch.train.step import (classification_loss_fn,
                                                  make_train_step,
                                                  shard_batch)

    mesh = build_mesh({"dp": torch.distributed.get_world_size()},
                      device_type="cpu")
    if case["model"] == "resnet18":
        group = None if case.get("per_rank_bn") else mesh.group("dp")
        model = resnet.ResNet18(num_classes=10, dtype=torch.float32,
                                bn_group=group)
        recipe = optim.sgd(case["lr"])
    else:
        model = vit.ViT(vit.vit_base_config(dtype=torch.float32,
                                            **case["config"]),
                        num_classes=10, patch_size=4, image_size=16)
        recipe = optim.adamw(case["lr"])
    model.load_state_dict(case["init"])
    state = create_train_state(model, recipe, seed=None)
    step = make_train_step(classification_loss_fn(model), mesh=mesh)
    losses = []
    for batch in case["batches"]:
        state, metrics = step(state, shard_batch(batch, mesh))
        losses.append(float(metrics["loss"]))
    return {"losses": torch.tensor(losses, dtype=torch.float64),
            "state": model.state_dict()}


def main(job_file, rank, world, store, out_dir) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    job = torch.load(job_file, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=int(rank), world_size=int(world))
    try:
        run = {"attention": attention_case, "lm": lm_case,
               "classify": classify_case}[job["kind"]]
        results = {case["name"]: run(case) for case in job["cases"]}
        torch.save(results, Path(out_dir) / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
