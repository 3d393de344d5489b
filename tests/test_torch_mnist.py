"""Parity of the port's MNIST models, `optim.adam`, `synthetic_mnist` and
the mnist workload with the JAX package's.

Both frameworks see the same numpy batches in f32; flax params are
initialised from a seed and carried over with `mnist_from_flax`.

Tolerances:
  * logits: 1e-5 x max |ref| (the same products summed in another order);
  * 3 Adam steps at the workload's lr 1e-3 through the JAX
    `make_train_step` with `optax.adam` against the port's
    `make_train_step` with `optim.adam`: losses 5e-5 relative, parameters
    1e-4 absolute (the multi-step tolerances of the LM's parity tests),
    except where a step's gradient is nonzero but below 10 x Adam's eps
    (1e-7).  There the update lr * m / (sqrt(v) + eps) follows the ratio of
    the gradient to eps, so the f32 rounding of so small a gradient (a
    saturated softmax's 1 - p, summed with cancellation) moves the step by
    up to lr: the CNN's dense_0 element [408, 2738] gets -6.37e-9 from JAX
    and -1.46e-9 from the port in the third step, and moves 1.72e-4
    against 4.97e-5.  Those elements (1,313 of the CNN's 3,274,634, 27 of
    the MLP's 397,510; at most 1e-3 of them) are held within 3 x lr, the
    most three Adam steps can move them;
  * `synthetic_mnist`: bit-identical.
Two planted faults must fail both the logits and the 3-step checks: the
CNN's [7, 7, 64] maps flattened in NCHW order (same shapes, other logits),
and the CNN's dropout left live (the port's train step sets
`Module.training`; the JAX workload calls the CNN with train=False).
"""
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import mnist as JM
from tf_operator_tpu.train.data import synthetic_mnist as j_synthetic_mnist
from tf_operator_tpu.train.state import create_train_state as j_create
from tf_operator_tpu.train.step import classification_loss_fn as j_loss_fn
from tf_operator_tpu.train.step import make_train_step as j_make_step
from tf_operator_tpu_torch.models import mnist as M
from tf_operator_tpu_torch.models.convert import (mnist_from_flax,
                                                  mnist_to_flax)
from tf_operator_tpu_torch.train import optim
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
from tf_operator_tpu_torch.train.data import synthetic_mnist
from tf_operator_tpu_torch.train.state import (create_train_state,
                                               full_state)
from tf_operator_tpu_torch.train.step import (classification_loss_fn,
                                              make_train_step)
from tf_operator_tpu_torch.workloads import mnist as mnist_workload

torch.set_num_threads(1)

LOGITS_RTOL = 1e-5
LOSS_RTOL = 5e-5
PARAM_ATOL = 1e-4
LR = 1e-3  # the mnist workload's default
BATCH = 16

MODELS = {
    "mlp": (JM.MnistMLP, M.MnistMLP, {}, 397_510),
    "cnn": (JM.MnistCNN, M.MnistCNN, {"train": False}, 3_274_634),
}


def nchw_flatten(x):
    return x.reshape(x.shape[0], -1)


@pytest.fixture(scope="module", params=sorted(MODELS))
def setup(request):
    jcls, _, kwargs, _ = MODELS[request.param]
    params = jcls().init(jax.random.PRNGKey(0), jnp.zeros((2, 784)),
                         **kwargs)["params"]
    return {"name": request.param, "params": jax.device_get(params),
            "kwargs": kwargs,
            "batches": [next(synthetic_mnist(BATCH, seed=s))
                        for s in (1, 2, 3)]}


def port_model(setup, fault=None, monkeypatch=None):
    """The port's model with the flax params; with `fault` one of the
    planted faults (CNN only)."""
    _, pcls, kwargs, _ = MODELS[setup["name"]]
    model = pcls()
    model.load_state_dict(mnist_from_flax(setup["params"]))
    if fault == "nchw_flatten":
        monkeypatch.setattr(model, "flatten", nchw_flatten)
    forward = model
    if kwargs:
        forward = functools.partial(
            model, train=(fault == "live_dropout"))
    return model, forward


def logits_error(setup, forward):
    """max |port - flax| / max |flax| of the logits on the first batch."""
    jcls = MODELS[setup["name"]][0]
    x = setup["batches"][0]["x"]
    ref = np.asarray(jcls().apply({"params": setup["params"]}, x,
                                  **setup["kwargs"]))
    torch.manual_seed(0)
    with torch.no_grad():
        got = forward(torch.from_numpy(x)).numpy()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


EPS_FLOOR = 1e-7  # 10 x optax.adam's eps
MAX_FLOORED = 1e-3  # share of the parameters that may sit there


def jax_three_steps(setup):
    """(losses, params after the 3 steps, {name: elements whose gradient
    was nonzero and below EPS_FLOOR in some step}) in the port's layout."""
    jcls = MODELS[setup["name"]][0]
    model = jcls()
    state = j_create(jax.random.PRNGKey(0), model, optax.adam(LR),
                     jnp.zeros((2, 784)), init_kwargs=setup["kwargs"])
    state = state.replace(params=setup["params"],
                          opt_state=optax.adam(LR).init(setup["params"]))
    loss_fn = j_loss_fn(model.apply, model_kwargs=setup["kwargs"])
    step = j_make_step(loss_fn, donate=False)
    grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))
    losses, floored = [], None
    for batch in setup["batches"]:
        g = mnist_from_flax(jax.device_get(grad(state.params, batch)))
        small = {n: (v != 0) & (v.abs() < EPS_FLOOR) for n, v in g.items()}
        floored = small if floored is None else {
            n: floored[n] | small[n] for n in small}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, mnist_from_flax(jax.device_get(state.params)), floored


@pytest.fixture(scope="module")
def jax_steps(setup):
    return jax_three_steps(setup)


def port_three_steps(setup, model, forward):
    state = create_train_state(model, optim.adam(LR), seed=None)
    step = make_train_step(classification_loss_fn(forward))
    torch.manual_seed(0)
    losses = []
    for batch in setup["batches"]:
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    return losses, model.state_dict()


def steps_error(setup, jax_steps, model, forward):
    """(worst relative loss error, worst absolute parameter error off the
    eps floor, worst on it) of 3 port steps against JAX's."""
    want_losses, want_params, floored = jax_steps
    got_losses, got_params = port_three_steps(setup, model, forward)
    loss_err = max(abs(g - w) / abs(w)
                   for g, w in zip(got_losses, want_losses))
    off, on = 0.0, 0.0
    for n, v in want_params.items():
        err = (got_params[n] - v).abs()
        off = max(off, float(err[~floored[n]].max()))
        if floored[n].any():
            on = max(on, float(err[floored[n]].max()))
    return loss_err, off, on


def test_reference_widths(setup):
    model, _ = port_model(setup)
    assert sum(p.numel() for p in model.parameters()) == \
        MODELS[setup["name"]][3]
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_logits_match_flax(setup):
    assert logits_error(setup, port_model(setup)[1]) <= LOGITS_RTOL


def test_converter_round_trips(setup):
    model, _ = port_model(setup)
    back = mnist_to_flax(model.state_dict())
    want = jax.tree_util.tree_flatten_with_path(setup["params"])[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_adam_steps_match_jax(setup, jax_steps):
    loss_err, off, on = steps_error(setup, jax_steps, *port_model(setup))
    assert loss_err <= LOSS_RTOL
    assert off <= PARAM_ATOL
    assert on <= 3 * LR
    floored = sum(int(m.sum()) for m in jax_steps[2].values())
    assert floored <= MAX_FLOORED * MODELS[setup["name"]][3]
    # the steps moved the parameters well beyond the tolerance
    init = mnist_from_flax(setup["params"])
    moved = max(float((jax_steps[1][n] - v).abs().max())
                for n, v in init.items())
    assert moved > 10 * PARAM_ATOL


@pytest.mark.parametrize("setup", ["cnn"], indirect=True)
@pytest.mark.parametrize("fault", ["nchw_flatten", "live_dropout"])
def test_planted_cnn_faults_fail(setup, jax_steps, fault, monkeypatch):
    _, forward = port_model(setup, fault, monkeypatch)
    assert logits_error(setup, forward) > 10 * LOGITS_RTOL
    loss_err, off, _ = steps_error(
        setup, jax_steps, *port_model(setup, fault, monkeypatch))
    assert loss_err > LOSS_RTOL and off > PARAM_ATOL


def test_adam_is_optax_adam():
    """`optim.adam` fed the same gradients as `optax.adam` for 3 updates
    at lr 1.0 (steps of ~lr, so the moments and bias corrections show)."""
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(4, 3).astype(np.float32)}
    grads = [{"w": rng.randn(4, 3).astype(np.float32)} for _ in range(3)]
    tx = optax.adam(1.0)
    opt_state, jp = tx.init(params), params
    w = torch.nn.Parameter(torch.from_numpy(params["w"].copy()))
    module = torch.nn.Module()
    module.w = w
    recipe = optim.adam(1.0)
    optimizer = recipe.init(module)
    for count, g in enumerate(grads):
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        w.grad = torch.from_numpy(g["w"].copy())
        recipe.update(optimizer, [w], count)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]),
                               atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 3, 101])
def test_synthetic_mnist_is_jaxs_stream(seed):
    ours, theirs = synthetic_mnist(BATCH, seed), j_synthetic_mnist(BATCH, seed)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key])


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("TPUJOB_FORCE_PLATFORM", "cpu")
    for key in ("TF_CONFIG", "TPUJOB_REPLICA_TYPE", "TPUJOB_REPLICA_INDEX",
                "TPUJOB_PROCESS_ID", "TPUJOB_NUM_PROCESSES"):
        monkeypatch.delenv(key, raising=False)


def test_mnist_workload_lines_and_target_exit(on_cpu, capsys):
    assert mnist_workload.main(["--steps", "12", "--batch", "16",
                                "--model", "cnn"]) == 0
    out = capsys.readouterr().out
    assert "mnist workload: role=worker index=0 nproc=1" in out
    assert [int(i) for i in re.findall(r"^step (\d+) loss \S+$", out,
                                       re.M)] == [0, 10]
    assert re.search(r"^step time \S+ ms over steps 1-11, \S+ images/s$",
                     out, re.M), out
    assert re.search(r"^final loss \S+$", out, re.M)
    # a target the run cannot reach exits 1
    assert mnist_workload.main(["--steps", "1", "--target-loss",
                                "1e-9"]) == 1
    assert "target loss 1e-09 not reached" in capsys.readouterr().out


def test_mnist_preempt_resume_restores_the_saved_state(on_cpu, tmp_path,
                                                       capsys):
    """First life: exit 143 at step 5 after a blocking save; the restored
    state is the saved one bit for bit; the second life resumes at step 5,
    saves every 4 steps in the background (the newest 3 kept) and
    finishes."""
    ckpt = str(tmp_path / "ckpt")
    args = ["--steps", "12", "--batch", "16", "--checkpoint-dir", ckpt,
            "--preempt-at-step", "5", "--save-every", "4"]
    assert mnist_workload.main(args) == 143
    out = capsys.readouterr().out
    assert "preempted at step 5, checkpoint saved" in out
    # steps 4 (periodic) and 5 (the preemption's)
    assert CheckpointManager(ckpt).all_steps() == [4, 5]

    saved = torch.load(os.path.join(ckpt, "5", "state.pt"),
                       weights_only=True)
    template = create_train_state(M.MnistMLP(), optim.adam(LR), seed=7)
    restored = full_state(CheckpointManager(ckpt).restore(template))
    assert restored["step"] == saved["step"] == 5
    for name, t in saved["model"].items():
        assert torch.equal(restored["model"][name], t), name
    for name, moments in saved["optimizer"].items():
        for key, t in moments.items():
            assert torch.equal(restored["optimizer"][name][key], t), name

    assert mnist_workload.main(args) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 5" in out
    assert "preempted" not in out
    assert [int(i) for i in re.findall(r"^step (\d+) loss", out, re.M)] \
        == [10]
    assert "final loss" in out
    assert CheckpointManager(ckpt).all_steps() == [5, 8, 12]
