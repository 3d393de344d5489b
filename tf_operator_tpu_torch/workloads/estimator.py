"""Estimator-style workload: every decision comes from the parsed RunConfig.

The counterpart of `tf_operator_tpu/workloads/estimator.py`, the
equivalent of TF Estimator's `train_and_evaluate` (the reference's
estimator-API example, estimator_runconfig_tests.py:26-102 asserts the
fields).  It consumes ONLY `workloads/runner.runconfig_from_env` — never
raw env — and dispatches:

    ps         -> serve a parameter shard from host memory (train/ps.py)
    evaluator  -> poll model_dir for checkpoints the chief writes, evaluate
                  each, exit when the chief publishes DONE
    chief      -> train (PS strategy when num_ps_replicas > 0, else local),
                  checkpoint to model_dir, publish DONE (is_chief=True is
                  the only replica that writes)
    worker     -> train the same way, write nothing

A wrong RunConfig therefore fails by behavior: a worker that wrongly sees
is_chief=True double-writes DONE; a chief with a bad master/cluster view
cannot reach its PS shards.

Gradients and losses are computed on the device by `MnistMLP` (seed 0 in
every process); parameters travel and are checkpointed as f32 arrays under
their flax names and layouts (`ckpt-<step>.npz`, the JAX workload's files),
so either package's evaluator reads either package's chief.

Usage: python -m tf_operator_tpu_torch.workloads.estimator --steps 60 \
           --model-dir /tmp/model
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _save_checkpoint(model_dir: str, step: int, flat_params) -> None:
    import numpy as np

    os.makedirs(model_dir, exist_ok=True)
    # .npz suffix on the temp name too — np.savez appends one otherwise
    tmp = os.path.join(model_dir, f".ckpt-{step}.tmp.npz")
    np.savez(tmp, **flat_params)
    os.replace(tmp, os.path.join(model_dir, f"ckpt-{step}.npz"))


def _latest_checkpoint(model_dir: str):
    try:
        names = [n for n in os.listdir(model_dir)
                 if n.startswith("ckpt-") and n.endswith(".npz")]
    except OSError:
        return None, None
    if not names:
        return None, None
    steps = sorted(int(n[5:-4]) for n in names)
    latest = steps[-1]
    return latest, os.path.join(model_dir, f"ckpt-{latest}.npz")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--model-dir", required=True)
    parser.add_argument("--checkpoint-every", type=int, default=20)
    parser.add_argument("--eval-timeout", type=float, default=120.0)
    args = parser.parse_args(argv)

    from .runner import apply_forced_platform, runconfig_from_env

    try:
        device = apply_forced_platform()
    except RuntimeError as e:
        print(f"estimator: {e}", flush=True)
        return 1
    rc = runconfig_from_env()
    print(f"estimator: runconfig={json.dumps(rc)}", flush=True)

    import numpy as np
    import torch

    from ..models.convert import mnist_to_flax
    from ..models.mnist import MnistMLP
    from ..train import ps as ps_lib
    from ..train.data import synthetic_mnist
    from ..train.step import softmax_cross_entropy
    from .dist_mnist import grad_fn, load_flat

    model = MnistMLP()
    model.reset_parameters(torch.Generator().manual_seed(0))
    flat_init = ps_lib.flatten_params(mnist_to_flax(model.state_dict()))
    done_path = os.path.join(args.model_dir, "DONE")

    def on_device(batch):
        return (torch.from_numpy(batch["x"]).to(device),
                torch.from_numpy(batch["label"]).to(device))

    # ---- ps: shard server, address from the RunConfig cluster view -------
    if rc["task_type"] == "ps":
        return ps_lib.serve_shard(
            flat_init, list(rc["cluster_spec"].get("ps", [])),
            rc["task_id"], args.lr)

    model.to(device)

    # ---- evaluator: consume checkpoints until the chief publishes DONE ---
    if rc["task_type"] == "evaluator":
        data = synthetic_mnist(args.batch, seed=999)
        seen = set()
        deadline = time.time() + args.eval_timeout
        while time.time() < deadline:
            step, path = _latest_checkpoint(args.model_dir)
            if step is not None and step not in seen:
                seen.add(step)
                with np.load(path) as z:
                    flat = {k: z[k] for k in z.files}
                load_flat(model, flat, flat_init)
                x, y = on_device(next(data))
                with torch.no_grad():
                    loss = float(softmax_cross_entropy(model(x), y))
                print(f"eval step={step} loss={loss:.4f}", flush=True)
            if os.path.exists(done_path) and seen:
                print(f"evaluator done ({len(seen)} checkpoint(s))", flush=True)
                return 0
            time.sleep(0.2)
        print("evaluator timed out waiting for checkpoints", flush=True)
        return 1

    # ---- chief / worker: train, strategy chosen from the RunConfig -------
    use_ps = rc["num_ps_replicas"] > 0
    data = synthetic_mnist(args.batch, seed=rc["task_id"])

    if use_ps:
        try:
            client, flat = ps_lib.connect_with_retry(rc["cluster_spec"]["ps"])
        except ConnectionError as e:
            print(str(e), flush=True)
            return 1
        for step in range(args.steps):
            _, grads = grad_fn(model, flat, flat_init, *on_device(next(data)))
            try:
                client.push(grads)
                flat = client.pull()
            except (OSError, ConnectionError):
                if os.path.exists(done_path):
                    # chief finished and shut the PS fleet down mid-step:
                    # training is over, not broken
                    print("PS fleet shut down after DONE; stopping", flush=True)
                    break
                raise
            if rc["is_chief"] and (step + 1) % args.checkpoint_every == 0:
                _save_checkpoint(args.model_dir, step + 1, flat)
        if rc["is_chief"] and args.steps % args.checkpoint_every != 0:
            _save_checkpoint(args.model_dir, args.steps, flat)
    else:
        flat = dict(flat_init)
        for step in range(args.steps):
            _, grads = grad_fn(model, flat, flat_init, *on_device(next(data)))
            flat = {k: flat[k] - args.lr * g for k, g in grads.items()}
            if rc["is_chief"] and (step + 1) % args.checkpoint_every == 0:
                _save_checkpoint(args.model_dir, step + 1, flat)
        if rc["is_chief"] and args.steps % args.checkpoint_every != 0:
            _save_checkpoint(args.model_dir, args.steps, flat)

    if rc["is_chief"]:
        os.makedirs(args.model_dir, exist_ok=True)
        with open(done_path, "w") as f:
            f.write("done\n")
        print("chief: published DONE", flush=True)
        if use_ps:
            # shut the PS fleet down so cleanPodPolicy None cannot leak
            # serving processes (workers racing a final step see DONE and
            # stop cleanly)
            try:
                client.shutdown_servers()
            except (OSError, ConnectionError):
                pass
    if use_ps:
        client.close()
    print(f"{rc['task_type']} {rc['task_id']}: finished {args.steps} steps",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
