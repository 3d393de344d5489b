"""Parity of the PyTorch port's ResNet (flax-exact BatchNorm, "SAME"
padding, SGD) with the JAX package's.

ResNet18 with 10 classes on a batch of 8 images at 32x32 and 30x30 (whose
stem output is 15 wide: an odd size, where flax's "SAME" pads the
stride-2 3x3 max-pool (1, 1), not (0, 1)).
flax params are initialised from a seed and carried over with
`resnet_from_flax`; both models see the same numpy images, in f32.  For the
forward and gradient checks every BatchNorm's scale and bias is then drawn
at random, so no residual branch is switched off by its zero-initialised
scale; the SGD steps start from flax's own init, as the workload does (with
random scales the last stage, which normalises 8 values per channel, makes
the trajectories of two correct implementations part within 3 steps).

Tolerances (f32 on both sides; the frameworks sum in other orders):
  * train-mode and eval-mode logits: 2e-4 absolute (logits ~3);
  * updated batch_stats: 2e-5 absolute;
  * the gradients of the loss: each within 1e-4 of its tensor's largest
    gradient (the last stage's BatchNorm divides by the spread of 8 values);
  * 3 SGD steps (lr 0.01, momentum 0.9) against the JAX `make_train_step`
    with `has_batch_stats`: loss 5e-5, params and batch_stats 2e-5
    absolute.
Planted faults that must fail: a BatchNorm that updates its running
variance with the unbiased variance, and a stride-2 conv that pads (0, 1)
whatever the size (caught at 30x30 only).  The eval step is held against
JAX's on the same params and running statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models.resnet import ResNet18 as JResNet18
from tf_operator_tpu.train import data as jdata
from tf_operator_tpu.train.state import create_train_state as j_create
from tf_operator_tpu.train.step import classification_loss_fn as j_loss_fn
from tf_operator_tpu.train.step import classification_metrics as j_metrics
from tf_operator_tpu.train.step import make_eval_step as j_eval_step
from tf_operator_tpu.train.step import make_train_step as j_make_step
from tf_operator_tpu_torch.models import resnet as R
from tf_operator_tpu_torch.models.convert import (resnet_from_flax,
                                                  resnet_to_flax)
from tf_operator_tpu_torch.train import data as tdata
from tf_operator_tpu_torch.train.optim import sgd
from tf_operator_tpu_torch.train.state import create_train_state
from tf_operator_tpu_torch.train.step import (classification_loss_fn,
                                              classification_metrics,
                                              make_eval_step,
                                              make_train_step)

torch.set_num_threads(1)

LOGITS_ATOL = 2e-4
STATS_ATOL = 2e-5
LOSS_ATOL = 5e-5
STEP_ATOL = 2e-5
GRAD_RTOL = 1e-4
LR = 0.01
SIZES = (32, 30)


def images(size, seed=0):
    return np.random.RandomState(seed).randn(8, size, size, 3).astype(
        np.float32)


def _randomize_norms(tree, rng):
    for value in tree.values():
        if isinstance(value, dict) and "scale" in value:
            value["scale"] = (1 + 0.2 * rng.randn(*value["scale"].shape)
                              ).astype(np.float32)
            value["bias"] = (0.1 * rng.randn(*value["bias"].shape)
                             ).astype(np.float32)
        elif isinstance(value, dict):
            _randomize_norms(value, rng)


def flax_init(size, random_norms=True):
    model = JResNet18(num_classes=10, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((2, size, size, 3)), train=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    if random_norms:
        _randomize_norms(params, np.random.RandomState(1))
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    return model, params, stats


def port_model(params, stats):
    model = R.ResNet18(num_classes=10, dtype=torch.float32)
    model.load_state_dict(resnet_from_flax(params, stats))
    return model


def assert_stats_close(ours, theirs, atol):
    _, got = resnet_to_flax(ours, "ResNetBlock")
    want = jax.tree_util.tree_leaves_with_path(theirs)
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), atol=atol,
                                   rtol=0, err_msg=str(path))


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s}px")
def forward(request):
    """JAX's train-mode logits and updated stats and eval-mode logits, for
    one image size."""
    size = request.param
    model, params, stats = flax_init(size)
    x = images(size)
    logits, updates = model.apply({"params": params, "batch_stats": stats},
                                  x, train=True, mutable=["batch_stats"])
    eval_logits = model.apply(
        {"params": params, "batch_stats": updates["batch_stats"]}, x,
        train=False)
    return dict(size=size, params=params, stats=stats, x=x,
                logits=np.asarray(logits), updated=updates["batch_stats"],
                eval_logits=np.asarray(eval_logits))


def test_train_mode_logits_match_flax(forward):
    model = port_model(forward["params"], forward["stats"]).train()
    with torch.no_grad():
        got = model(torch.from_numpy(forward["x"]))
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    np.testing.assert_allclose(got.numpy(), forward["logits"],
                               atol=LOGITS_ATOL, rtol=0)


def test_updated_batch_stats_match_flax(forward):
    model = port_model(forward["params"], forward["stats"]).train()
    with torch.no_grad():
        model(torch.from_numpy(forward["x"]))
    assert_stats_close(model.state_dict(), forward["updated"], STATS_ATOL)


def test_eval_mode_logits_match_flax_and_leave_the_stats(forward):
    model = port_model(forward["params"], forward["stats"]).train()
    with torch.no_grad():
        model(torch.from_numpy(forward["x"]))
        model.eval()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        got = model(torch.from_numpy(forward["x"]))
    np.testing.assert_allclose(got.numpy(), forward["eval_logits"],
                               atol=LOGITS_ATOL, rtol=0)
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_planted_unbiased_running_variance_fails(forward, monkeypatch):
    """torch's update (the unbiased variance, count / (count - 1) times the
    biased one) must not pass the stats comparison."""
    def unbiased(running_mean, running_var, mean, var, count):
        running_mean.mul_(R.MOMENTUM).add_(mean, alpha=1 - R.MOMENTUM)
        running_var.mul_(R.MOMENTUM).add_(var * count / (count - 1),
                                          alpha=1 - R.MOMENTUM)

    monkeypatch.setattr(R, "update_running", unbiased)
    model = port_model(forward["params"], forward["stats"]).train()
    with torch.no_grad():
        model(torch.from_numpy(forward["x"]))
    with pytest.raises(AssertionError):
        assert_stats_close(model.state_dict(), forward["updated"],
                           STATS_ATOL)


def test_planted_fixed_stride2_padding_fails_at_odd_sizes(forward,
                                                          monkeypatch):
    """A max-pool (and conv) that pads a stride-2 3x3 by (0, 1) whatever
    the size agrees with flax at 32x32 and must not at 30x30, where it
    shrinks the stem's odd (15-wide) map to 7 instead of 8, so a block's
    residual no longer fits its output (or, failing that, the logits
    move)."""
    same = R.same_padding

    def fixed(n, k, s):
        return (0, 1) if (k, s) == (3, 2) else same(n, k, s)

    monkeypatch.setattr(R, "same_padding", fixed)
    model = port_model(forward["params"], forward["stats"]).train()
    try:
        with torch.no_grad():
            got = model(torch.from_numpy(forward["x"])).numpy()
        off = float(np.abs(got - forward["logits"]).max())
    except RuntimeError as e:
        assert "must match the size" in str(e)
        off = float("inf")
    if (forward["size"] // 2) % 2:  # the stem's output is odd
        assert off > 100 * LOGITS_ATOL
    else:
        assert off <= LOGITS_ATOL


def test_gradients_match_jax(forward):
    """The loss's gradient for every parameter (BatchNorm's backward
    through the batch statistics included) in train mode."""
    model, params, stats = flax_init(forward["size"])
    labels = np.arange(8, dtype=np.int32) % 10
    batch = {"x": forward["x"], "label": labels}
    loss_fn = j_loss_fn(model.apply, has_batch_stats=True,
                        model_kwargs={"train": True})
    want = jax.jit(jax.grad(lambda p: loss_fn(p, batch, stats)[0]))(params)
    want = resnet_from_flax(jax.tree_util.tree_map(np.asarray, want), stats)
    tmodel = port_model(params, stats).train()
    loss, _ = classification_loss_fn(tmodel)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    for name, p in tmodel.named_parameters():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        err = float((p.grad - want[name]).abs().max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("n,k,s", [(56, 3, 2), (15, 3, 2), (112, 3, 2),
                                   (56, 1, 2), (15, 1, 2), (7, 3, 1),
                                   (1, 3, 2), (224, 7, 2)])
def test_same_padding_is_xlas(n, k, s):
    want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert R.same_padding(n, k, s) == tuple(want)


def test_converter_round_trips():
    _, params, stats = flax_init(32)
    back_params, back_stats = resnet_to_flax(
        port_model(params, stats).state_dict(), "ResNetBlock")
    for want, got in ((params, back_params), (stats, back_stats)):
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_want) == len(flat_got)
        for path, leaf in flat_want:
            np.testing.assert_array_equal(flat_got[path], np.asarray(leaf))


def test_checkpoint_carries_the_running_statistics(tmp_path):
    """BatchNorm's running statistics are module buffers: they ride in
    state_dict(), so a checkpoint restores them with the params and the
    SGD momentum."""
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    def state():
        model = R.ResNet18(num_classes=10, dtype=torch.float32)
        return create_train_state(model, sgd(LR), seed=0)

    trained = state()
    step = make_train_step(classification_loss_fn(trained.model))
    batch = next(tdata.synthetic_images(8, 32, 10, seed=2))
    trained, _ = step(trained, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(trained)
    restored = mgr.restore(state())
    mgr.close()
    assert restored.step == 1
    want = trained.model.state_dict()
    assert not torch.equal(want["bn_init.running_var"],
                           torch.ones_like(want["bn_init.running_var"]))
    for key, value in restored.model.state_dict().items():
        assert torch.equal(value, want[key]), key
    assert restored.optimizer.state_dict()["state"].keys() == \
        trained.optimizer.state_dict()["state"].keys()


def test_synthetic_images_are_the_reference_stream():
    for ours, theirs, _ in zip(tdata.synthetic_images(4, 16, 10, seed=3),
                               jdata.synthetic_images(4, 16, 10, seed=3),
                               range(2)):
        for key in ("x", "label"):
            assert ours[key].dtype == theirs[key].dtype
            np.testing.assert_array_equal(ours[key], theirs[key])


def test_init_is_flaxs():
    """Zero scale on each block's last BatchNorm, unit running variance,
    lecun-normal convs and head (std 1/sqrt(fan_in), truncated at 2
    std)."""
    model = R.ResNet50(num_classes=10, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    for block in model.blocks:
        assert not block.norms[-1].weight.any()
        assert torch.equal(block.norms[0].weight,
                           torch.ones_like(block.norms[0].weight))
    w = model.blocks[3].convs[1].weight.detach()  # 3x3, 128 -> 128
    std = (1 / w[0].numel()) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.equal(model.bn_init.running_var,
                       torch.ones_like(model.bn_init.running_var))


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s}px")
def trained(request):
    """3 SGD steps in both frameworks from the same params and batches,
    then the eval step on a fourth batch."""
    size = request.param
    model, params, stats = flax_init(size, random_norms=False)
    data = [b for b, _ in zip(jdata.synthetic_images(8, size, 10, seed=1),
                              range(4))]
    state = j_create(jax.random.PRNGKey(0), model, optax.sgd(LR, 0.9),
                     jnp.zeros((2, size, size, 3)),
                     init_kwargs={"train": True})
    state = state.replace(params=params, batch_stats=stats)
    step = j_make_step(
        j_loss_fn(model.apply, has_batch_stats=True,
                  model_kwargs={"train": True}),
        has_batch_stats=True, donate=False)
    jax_losses = []
    for batch in data[:3]:
        state, metrics = step(state, batch)
        jax_losses.append(float(metrics["loss"]))

    tmodel = port_model(params, stats)
    tstate = create_train_state(tmodel, sgd(LR), seed=None)
    tstep = make_train_step(classification_loss_fn(tmodel))
    losses = []
    for batch in data[:3]:
        tstate, metrics = tstep(tstate, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    port_eval = make_eval_step(classification_metrics(tmodel))(
        tstate, {k: torch.from_numpy(v) for k, v in data[3].items()})
    # JAX's eval step on the port's trained params and running statistics
    trained_params, trained_stats = resnet_to_flax(tmodel.state_dict(),
                                                   "ResNetBlock")
    jax_eval = j_eval_step(j_metrics(model.apply,
                                     model_kwargs={"train": False}))(
        state.replace(params=trained_params, batch_stats=trained_stats),
        data[3])
    return dict(jax_losses=jax_losses, jax_state=state, jax_eval=jax_eval,
                losses=losses, model=tmodel, eval=port_eval, init=params)


def test_sgd_steps_match_jax(trained):
    np.testing.assert_allclose(trained["losses"], trained["jax_losses"],
                               atol=LOSS_ATOL, rtol=0)
    got_params, _ = resnet_to_flax(trained["model"].state_dict(),
                                   "ResNetBlock")
    moved = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(
            trained["jax_state"].params):
        got = dict(jax.tree_util.tree_leaves_with_path(got_params))[path]
        np.testing.assert_allclose(got, np.asarray(want), atol=STEP_ATOL,
                                   rtol=0, err_msg=str(path))
    for path, before in jax.tree_util.tree_leaves_with_path(
            trained["init"]):
        want = dict(jax.tree_util.tree_leaves_with_path(
            trained["jax_state"].params))[path]
        moved = max(moved, float(np.abs(np.asarray(want) - before).max()))
    assert moved > 100 * STEP_ATOL  # the steps really moved the params
    assert_stats_close(trained["model"].state_dict(),
                       trained["jax_state"].batch_stats, STEP_ATOL)


def test_eval_step_matches_jax(trained):
    got, want = trained["eval"], trained["jax_eval"]
    assert set(got) == set(want) == {"loss", "accuracy"}
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               atol=LOSS_ATOL, rtol=0)
    assert float(got["accuracy"]) == float(want["accuracy"])
    assert not trained["model"].training
