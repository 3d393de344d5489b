"""Parity of the PyTorch port's training step with the JAX package's.

Both start from the same flax params (carried over with `params_from_flax`)
and take the same steps of `make_train_step(lm_loss_fn(...))` with
`lm_optimizer` (clip 1.0, weight decay 0.1, linear warmup + cosine) on the
same numpy batches, in f32.  Losses and parameters agree within 5e-5, the
reference's own tolerance for "same update math" (docs/zero-sharding.md):
the two frameworks sum gradients and moments in a different order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import transformer as J
from tf_operator_tpu.train import data as jdata
from tf_operator_tpu.train import optim as joptim
from tf_operator_tpu.train.state import create_train_state as j_create
from tf_operator_tpu.train.step import lm_loss_fn as j_loss_fn
from tf_operator_tpu.train.step import make_train_step as j_make_step
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models.convert import (
    params_from_flax,
    params_to_flax,
)
from tf_operator_tpu_torch.train import data as tdata
from tf_operator_tpu_torch.train import optim as toptim
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
from tf_operator_tpu_torch.train.state import create_train_state
from tf_operator_tpu_torch.train.step import lm_loss_fn, make_train_step

torch.set_num_threads(1)

ATOL = 5e-5
SMALL = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=128,
             max_len=32)
OPT = dict(schedule="cosine", warmup_steps=2, total_steps=5,
           weight_decay=0.1, grad_clip=1.0)


def configs(arch):
    if arch == "gpt":
        return (J.gpt_small_config(d_ff=128, dtype=jnp.float32, **SMALL),
                T.gpt_small_config(d_ff=128, dtype=torch.float32, **SMALL))
    kw = dict(num_kv_heads=2, d_ff=96, **SMALL)
    return (J.llama_style_config(dtype=jnp.float32, **kw),
            T.llama_style_config(dtype=torch.float32, **kw))


@pytest.mark.parametrize("arch,grad_accum,loss_chunk", [
    ("gpt", 1, 0), ("gpt", 2, 0), ("llama", 1, 8)])
def test_train_steps_match_jax(arch, grad_accum, loss_chunk):
    jcfg, tcfg = configs(arch)
    batches = [b["tokens"] for b, _ in
               zip(jdata.synthetic_tokens(4, 33, 128, seed=1), range(4))]

    jmodel = J.TransformerLM(jcfg)
    jstate = j_create(jax.random.PRNGKey(0), jmodel,
                      joptim.lm_optimizer(3e-3, **OPT),
                      jnp.zeros((2, 32), jnp.int32))
    model = T.TransformerLM(tcfg)
    model.load_state_dict(params_from_flax(jax.device_get(jstate.params)))
    state = create_train_state(model, toptim.lm_optimizer(3e-3, **OPT),
                               seed=None)

    jstep = j_make_step(j_loss_fn(jmodel.apply, loss_chunk=loss_chunk),
                        donate=False, grad_accum=grad_accum)
    step = make_train_step(lm_loss_fn(model, loss_chunk=loss_chunk),
                           grad_accum=grad_accum)
    for tokens in batches:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        assert abs(float(m["loss"]) - float(jm["loss"])) < ATOL
    assert state.step == int(jstate.step) == len(batches)

    got = params_to_flax(model.state_dict())
    want = jax.device_get(jstate.params)
    moved = 0.0
    for (path, w), (_, g), (_, init) in zip(
            jax.tree_util.tree_leaves_with_path(want),
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(params_to_flax(
                params_from_flax(jax.device_get(j_create(
                    jax.random.PRNGKey(0), jmodel,
                    joptim.lm_optimizer(3e-3, **OPT),
                    jnp.zeros((2, 32), jnp.int32)).params))))):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))
        moved = max(moved, float(np.abs(np.asarray(w) - init).max()))
    assert moved > 100 * ATOL  # the steps really moved the params


def test_synthetic_tokens_bit_identical():
    for args in ((4, 33, 128, 0), (2, 17, 32000, 5)):
        theirs = jdata.synthetic_tokens(*args)
        ours = tdata.synthetic_tokens(*args)
        for _ in range(3):
            a, b = next(theirs)["tokens"], next(ours)["tokens"]
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(schedule="constant"),
    dict(schedule="constant", warmup_steps=3),
    dict(schedule="cosine", total_steps=10),
    dict(schedule="cosine", warmup_steps=4, total_steps=10),
])
def test_lr_schedule_matches_optax(kw):
    theirs = joptim.lr_schedule(1e-3, **kw)
    ours = toptim.lr_schedule(1e-3, **kw)
    for count in range(14):
        assert abs(ours(count) - float(theirs(count))) < 1e-9


def test_lr_schedule_errors():
    with pytest.raises(ValueError, match="schedule must be"):
        toptim.lr_schedule(1e-3, schedule="linear")
    with pytest.raises(ValueError, match="total_steps"):
        toptim.lr_schedule(1e-3, schedule="cosine")


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_optax_without_epsilon(scale):
    """Below the limit the gradients pass unchanged; above it they are
    scaled by max_norm / norm exactly (torch's clip_grad_norm_ would add
    1e-6 to the norm)."""
    rng = np.random.RandomState(0)
    grads = [rng.randn(5, 3).astype(np.float32) * scale,
             rng.randn(7).astype(np.float32) * scale]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    toptim.clip_by_global_norm_(params, 1.0)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_decay_mask_matches_jax(arch):
    """Weight decay reaches the same tensors: rank >= 2 in the flax layout,
    which includes the [heads, head_dim] query/key/value biases."""
    jcfg, tcfg = configs(arch)
    model = T.TransformerLM(tcfg)
    mask = toptim.decay_mask(model)
    marked = params_to_flax({n: torch.full_like(p, float(mask[n]))
                             for n, p in model.named_parameters()})
    params = J.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    want = joptim.decay_mask(params)
    for (path, w), (_, m) in zip(jax.tree_util.tree_leaves_with_path(want),
                                 jax.tree_util.tree_leaves_with_path(marked)):
        assert bool(np.all(m == 1.0)) == bool(w), jax.tree_util.keystr(path)


def _state(seed=0):
    model = T.TransformerLM(T.gpt_small_config(d_ff=128, **SMALL))
    return create_train_state(model, toptim.lm_optimizer(1e-3), seed=seed)


def _train(state, n):
    step = make_train_step(lm_loss_fn(state.model))
    data = tdata.prefetch_to_device(tdata.synthetic_tokens(2, 17, 128),
                                    "cpu")
    for _ in range(n):
        state, _ = step(state, next(data))
    return state


def test_checkpoint_round_trip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    fresh = _state()
    assert mgr.latest_step() is None
    assert mgr.restore(fresh) is fresh and fresh.step == 0

    state = _train(_state(), 1)
    for _ in range(4):
        state = _train(state, 1)
        mgr.save(state, wait=False)
    # the final save of a step whose periodic save may still be writing
    mgr.save(state)
    mgr.close()
    assert mgr.all_steps() == [3, 4, 5]
    assert not any(p.name.startswith(".tmp") for p in tmp_path.iterdir())

    resumed = CheckpointManager(str(tmp_path)).restore(_state(seed=1))
    assert resumed.step == 5
    for a, b in zip(resumed.model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)
    opt_a = resumed.optimizer.state_dict()["state"]
    opt_b = state.optimizer.state_dict()["state"]
    assert opt_a.keys() == opt_b.keys()
    for key in opt_a:
        assert torch.equal(opt_a[key]["exp_avg_sq"], opt_b[key]["exp_avg_sq"])


def test_prefetch_yields_the_stream_in_order():
    batches = [{"tokens": np.full((2, 3), i, np.int32)} for i in range(5)]
    got = list(tdata.prefetch_to_device(iter(batches), "cpu", size=2))
    assert [int(b["tokens"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["tokens"], torch.Tensor) for b in got)


def test_grad_accum_validation():
    with pytest.raises(ValueError, match="grad_accum must be >= 1"):
        make_train_step(lambda b: None, grad_accum=0)
    state = _state()
    step = make_train_step(lm_loss_fn(state.model), grad_accum=3)
    with pytest.raises(ValueError, match="must divide by grad_accum"):
        step(state, {"tokens": torch.zeros(4, 9, dtype=torch.int32)})
    with pytest.raises(ValueError, match="loss_chunk must be >= 0"):
        lm_loss_fn(state.model, loss_chunk=-1)
