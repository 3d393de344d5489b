"""A deleted capture gives its memory back (ROADMAP C.4): after
`analysis/hlo.capture_built` and `del` of the capture and the `Built`,
`gc.collect()` leaves no parameter, gradient or optimizer moment of the
workload alive.  In a one-rank gloo group in this process, at the JAX
package's tiny capture shapes; no JAX.  And the recorder's own count of
dispatched collectives still catches one that goes past its wrappers.
"""
import gc
import weakref

import pytest
import torch
import torch.distributed as dist

from tf_operator_tpu_torch.analysis import hlo


@pytest.fixture
def one_rank_group(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUJOB_FORCE_PLATFORM", "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", hlo.TRAIN_WORKLOADS)
def test_a_deleted_capture_frees_parameters_gradients_and_moments(
        one_rank_group, name):
    built = hlo.build_workload(name, zero=True)
    cap = hlo.capture_built(name, built, True)
    params = list(built.model.parameters())
    grads = [p.grad for p in params if p.grad is not None]
    moments = [t for state in built.state.optimizer.state.values()
               for t in state.values() if isinstance(t, torch.Tensor)]
    assert params and grads and moments
    refs = [weakref.ref(t) for t in params + grads + moments]
    del cap, built, params, grads, moments
    gc.collect()
    alive = sum(r() is not None for r in refs)
    assert alive == 0, f"{alive} of {len(refs)} tensors outlive the capture"


def test_the_dispatch_count_catches_a_collective_past_the_wrappers(
        one_rank_group):
    import torch.distributed._functional_collectives as funcol

    t = torch.ones(4)
    with hlo.CollectiveRecorder() as rec:
        dist.all_reduce(t)
        dist.broadcast(t, 0)
    assert [op.kind for op in rec.ops] == ["all-reduce", "broadcast"]
    with pytest.raises(RuntimeError, match="went past the recorder's"):
        with hlo.CollectiveRecorder():
            dist.all_reduce(t)
            funcol.wait_tensor(funcol.all_reduce(t, "sum", dist.group.WORLD))
