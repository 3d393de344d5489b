"""Checkpoint / resume with `torch.save`.

The same contract as `tf_operator_tpu/train/checkpoint.py`, which the
restart state machine relies on: one directory per step under `directory`,
the newest `max_to_keep` kept, `latest_step()`, `restore(template)` that
returns the template unchanged when there is no checkpoint, and
`save(state, wait=)`.  A preempted gang that restarts resumes from the
latest complete step.

A save first copies the state to host memory (so training may go on
updating the parameters in place), then writes it on a background thread
unless `wait=True`.  The step directory is written under a temporary name
and renamed when complete, so `latest_step()` never sees a partial one.

The state is saved whole (`train/state.full_state`: every rank gathers
the parameters and moments its mesh shards, then rank 0 writes), so a
checkpoint written under one mesh restores under another, each rank
cutting its piece (`load_full_state`).  A state trained under a ZeRO plan
also gets the plan as a `zero_plan-<step>.json` sidecar beside its step
directory, pruned with it (`saved_zero_plan` reads it back).  Every rank
meets a barrier once its saves are on disk: at each `save(wait=True)`,
`wait_until_finished()` and `close()`, after rank 0 has joined its
background writes, so no rank reads or exits before the step it saved is
complete.
"""
from __future__ import annotations

import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import torch
import torch.distributed as dist

from .state import TrainState, full_state, load_full_state

_STATE_FILE = "state.pt"


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._executor: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []
        self._submitted: set = set()  # steps saved or being written
        self._writer = not dist.is_initialized() or dist.get_rank() == 0

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, _STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: Optional[int] = None,
             wait: bool = True) -> int:
        step = state.step if step is None else step
        if step in self._submitted:
            # already saved or being saved (the final save after a periodic
            # one at the same step, or the step restored); every rank
            # decides alike, so none gathers alone
            if wait:
                self.wait_until_finished()
            return step
        self._submitted.add(step)
        # every rank joins the gathers; rank 0 writes
        payload = _to_host(full_state(state))
        plan = None if state.zero_plan is None else state.zero_plan.to_json()
        if self._writer and step not in self.all_steps():
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="tpujob-ckpt")
            self._pending.append(
                self._executor.submit(self._write, step, payload, plan))
        if wait:
            self.wait_until_finished()
        return step

    def _plan_path(self, step: int) -> str:
        return os.path.join(self.directory, f"zero_plan-{step}.json")

    def _write(self, step: int, payload, plan: Optional[str]) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        if plan is not None:
            # beside the step directory, as the JAX package writes it
            with open(self._plan_path(step), "w") as f:
                f.write(plan)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        # a sidecar does not outlive its step directory
        keep = set(self.all_steps())
        for name in os.listdir(self.directory):
            if name.startswith("zero_plan-") and name.endswith(".json"):
                tag = name[len("zero_plan-"):-len(".json")]
                if tag.isdigit() and int(tag) not in keep:
                    os.remove(os.path.join(self.directory, name))

    def saved_zero_plan(self, step: Optional[int] = None, mesh=None):
        """The ZeroShardingPlan checkpoint `step` (default latest) was
        written under, or None for a dense one."""
        from .zero import ZeroShardingPlan

        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._plan_path(step)):
            return None
        with open(self._plan_path(step)) as f:
            return ZeroShardingPlan.from_json(f.read(), mesh=mesh)

    def wait_until_finished(self) -> None:
        """Block until every save has been written; re-raise a failed one.
        In a process group, then wait for every rank."""
        pending, self._pending = self._pending, []
        try:
            for fut in pending:
                fut.result()
        finally:
            if dist.is_initialized():
                dist.barrier()

    def restore(self, template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load checkpoint `step` (default latest) into the template's model
        and optimizer (each rank its piece, on the template's device);
        returns the template, which is unchanged if no checkpoint
        exists."""
        step = self.latest_step() if step is None else step
        if step is None:
            return template
        payload = torch.load(
            os.path.join(self.directory, str(step), _STATE_FILE),
            map_location="cpu", weights_only=True)
        load_full_state(template, payload)
        self._submitted.add(template.step)
        return template

    def close(self) -> None:
        self.wait_until_finished()
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None
