"""Parity of the PyTorch port's ViT and BERT encoder, and of its
`optim.adamw` recipe, with the JAX package's.

ViT: 2 layers, d 64, 4 heads, 16x16 images in patches of 4 (16 patches +
CLS, T 17), 10 classes.  BERT: the shape of the JAX package's fine-tune
test (2 layers, d 32, 4 heads, d_ff 64, max_len 32, vocab 100, T 16, two
labels).  flax params are initialised from a seed and carried over with
`vit_from_flax` / `bert_from_flax`; both frameworks see the same numpy
inputs, in f32.

Tolerances:
  * logits (and BERT's sequence output): 1e-5 absolute (values ~1-3; the
    same products summed in another order);
  * 3 `adamw` steps against `optax.adamw` through the JAX
    `make_train_step`: loss and params 5e-5 absolute, the "same update
    math" tolerance of the LM's step tests.  The attention key biases are
    left out of the params: softmax is invariant to a shift of its row, so
    their gradient is zero in exact arithmetic, and Adam turns the
    rounding noise each framework leaves there into steps of up to lr;
  * `adamw` alone, fed JAX's gradients for 3 updates of the model's own
    parameters at lr 1.0: 1e-4 absolute.  optax forms the bias
    corrections 1 - b^t in f32 (1 - f32(0.999) is 1.3e-5 off 1e-3) and
    torch in double, which moves each update by ~7e-6 of lr.  A recipe
    that masks the decay to rank >= 2 (the LM's) or keeps b2 0.95 (the
    LM's) is a planted fault and must fail it: the first leaves the norm
    scales undecayed (lr * 1e-4 a step, 3e-4 over the three), the second
    moves the second update by ~1e-2.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import transformer as JT
from tf_operator_tpu.models import vit as JV
from tf_operator_tpu.train.state import create_train_state as j_create
from tf_operator_tpu.train.step import classification_loss_fn as j_loss_fn
from tf_operator_tpu.train.step import classification_metrics as j_metrics
from tf_operator_tpu.train.step import make_eval_step as j_eval_step
from tf_operator_tpu.train.step import make_train_step as j_make_step
from tf_operator_tpu_torch.models import convert
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models import vit as V
from tf_operator_tpu_torch.train import optim
from tf_operator_tpu_torch.train.state import create_train_state
from tf_operator_tpu_torch.train.step import (classification_loss_fn,
                                              classification_metrics,
                                              make_eval_step,
                                              make_train_step)

torch.set_num_threads(1)

LOGITS_ATOL = 1e-5
STEP_ATOL = 5e-5
OPT_ATOL = 1e-4
OPT_LR = 1.0
LR = 1e-3
VIT = dict(num_layers=2, num_heads=4, d_model=64, d_ff=128, max_len=17)
BERT = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, max_len=32,
            vocab_size=100)


def vit_batch(seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(4, 16, 16, 3).astype(np.float32),
            "label": rng.randint(0, 10, 4).astype(np.int32)}


def bert_batch(seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.randint(0, 100, (8, 16)).astype(np.int32),
            "label": rng.randint(0, 2, 8).astype(np.int32)}


def vit_models():
    jmodel = JV.ViT(JV.vit_base_config(dtype=jnp.float32, **VIT),
                    num_classes=10, patch_size=4)
    tmodel = V.ViT(V.vit_base_config(dtype=torch.float32, **VIT),
                   num_classes=10, patch_size=4, image_size=16)
    return jmodel, tmodel, jmodel.apply, vit_batch, convert.vit_from_flax


def bert_models():
    jmodel = JT.BertEncoder(JT.bert_base_config(dtype=jnp.float32, **BERT),
                            num_labels=2)
    tmodel = T.BertEncoder(T.bert_base_config(dtype=torch.float32, **BERT),
                           num_labels=2)

    def apply_logits(variables, tokens, **kw):
        return jmodel.apply(variables, tokens, **kw)["logits"]

    return jmodel, tmodel, apply_logits, bert_batch, convert.bert_from_flax


MODELS = {"vit": vit_models, "bert": bert_models}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(MODELS))
def setup(request):
    jmodel, tmodel, apply_fn, make_batch, from_flax = MODELS[request.param]()
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), make_batch(0)["x"])["params"])
    tmodel.load_state_dict(from_flax(params))
    return dict(name=request.param, jmodel=jmodel, tmodel=tmodel,
                apply=apply_fn, batch=make_batch, params=params,
                from_flax=from_flax)


def test_logits_match_flax(setup):
    x = setup["batch"](0)["x"]
    want = setup["jmodel"].apply({"params": setup["params"]}, x)
    with torch.no_grad():
        got = setup["tmodel"](torch.from_numpy(x))
    if setup["name"] == "bert":
        assert set(got) == {"sequence_output", "logits"}
        np.testing.assert_allclose(got["sequence_output"].numpy(),
                                   np.asarray(want["sequence_output"]),
                                   atol=LOGITS_ATOL, rtol=0)
        got, want = got["logits"], want["logits"]
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)


def test_converter_round_trips(setup):
    to_flax = {"vit": convert.vit_to_flax,
               "bert": convert.bert_to_flax}[setup["name"]]
    back = to_flax(setup["tmodel"].state_dict())
    want = jax.tree_util.tree_leaves_with_path(setup["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_adamw_steps_match_optax(setup):
    """3 steps of the workload's recipe through both train steps."""
    jmodel, params = setup["jmodel"], setup["params"]
    batches = [setup["batch"](seed) for seed in (1, 2, 3)]
    state = j_create(jax.random.PRNGKey(0), jmodel, optax.adamw(LR),
                     batches[0]["x"])
    state = state.replace(params=params)
    step = j_make_step(j_loss_fn(setup["apply"]), donate=False)
    want = []
    for batch in batches:
        state, metrics = step(state, batch)
        want.append(float(metrics["loss"]))

    tmodel = MODELS[setup["name"]]()[1]
    tmodel.load_state_dict(setup["from_flax"](params))
    tstate = create_train_state(tmodel, optim.adamw(LR), seed=None)
    tstep = make_train_step(classification_loss_fn(tmodel))
    got = []
    for batch in batches:
        tstate, metrics = tstep(tstate, torch_batch(batch))
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, atol=STEP_ATOL, rtol=0)
    final = setup["from_flax"](jax.device_get(state.params))
    init = setup["from_flax"](params)
    moved = 0.0
    for name, value in tmodel.state_dict().items():
        if name.endswith("attn.key.bias"):
            continue  # no gradient in exact arithmetic (docstring)
        torch.testing.assert_close(value, final[name], atol=STEP_ATOL,
                                   rtol=0, msg=name)
        moved = max(moved, float((final[name] - init[name]).abs().max()))
    assert moved > 10 * STEP_ATOL


def _recipe_after_three_updates(setup, recipe):
    """(the port's params after 3 updates of `recipe` from JAX's
    gradients, optax.adamw's from the same gradients)."""
    params = setup["params"]
    loss_fn = j_loss_fn(setup["apply"])
    grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))
    tx = optax.adamw(OPT_LR)
    opt_state = tx.init(params)
    jparams = params
    tmodel = MODELS[setup["name"]]()[1]
    tmodel.load_state_dict(setup["from_flax"](params))
    optimizer = recipe.init(tmodel)
    named = dict(tmodel.named_parameters())
    for count, seed in enumerate((1, 2, 3)):
        g = grad(jparams, setup["batch"](seed))
        updates, opt_state = tx.update(g, opt_state, jparams)
        g_torch = setup["from_flax"](jax.device_get(g))
        jparams = optax.apply_updates(jparams, updates)
        for name, p in named.items():
            p.grad = g_torch[name].clone()
        recipe.update(optimizer, list(tmodel.parameters()), count)
    return tmodel.state_dict(), setup["from_flax"](jax.device_get(jparams))


def test_adamw_recipe_is_optaxs(setup):
    got, want = _recipe_after_three_updates(setup, optim.adamw(OPT_LR))
    for name, value in want.items():
        torch.testing.assert_close(got[name], value, atol=OPT_ATOL, rtol=0,
                                   msg=name)


@pytest.mark.parametrize("fault", ["decay_masked", "b2_095"])
def test_planted_lm_recipe_choices_fail(setup, fault):
    recipe = optim.adamw(OPT_LR)
    recipe = dataclasses.replace(
        recipe, **({"masked": True} if fault == "decay_masked"
                   else {"b2": 0.95}))
    got, want = _recipe_after_three_updates(setup, recipe)
    worst = max(float((got[name] - value).abs().max())
                for name, value in want.items())
    assert worst > 2 * OPT_ATOL, worst


def test_eval_step_matches_jax(setup):
    batch = setup["batch"](4)
    want = j_eval_step(j_metrics(setup["apply"]))(
        j_create(jax.random.PRNGKey(0), setup["jmodel"], optax.adamw(LR),
                 batch["x"]).replace(params=setup["params"]), batch)
    tstate = create_train_state(setup["tmodel"], optim.adamw(LR), seed=None)
    got = make_eval_step(classification_metrics(setup["tmodel"]))(
        tstate, torch_batch(batch))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               atol=LOGITS_ATOL, rtol=0)
    assert float(got["accuracy"]) == float(want["accuracy"])


@pytest.mark.parametrize("kwargs,image,message", [
    (dict(causal=True), 16, "ViT needs causal=False"),
    ({}, 18, "image 18x18 not divisible by patch size 4"),
    (dict(max_len=16), 16, "16 patches + CLS exceed max_len 16"),
])
def test_vit_raises_the_reference_errors(kwargs, image, message):
    cfg_kw = {**VIT, **kwargs}
    jmodel = JV.ViT(JV.vit_base_config(dtype=jnp.float32, **cfg_kw),
                    num_classes=10, patch_size=4)
    with pytest.raises(ValueError, match=re.escape(message)):
        jmodel.init(jax.random.PRNGKey(0),
                    jnp.zeros((1, image, image, 3)))
    with pytest.raises(ValueError, match=re.escape(message)):
        V.ViT(V.vit_base_config(dtype=torch.float32, **cfg_kw),
              num_classes=10, patch_size=4, image_size=image)


def test_vit_refuses_an_image_of_another_size():
    model = V.ViT(V.vit_base_config(dtype=torch.float32, **VIT),
                  num_classes=10, patch_size=4, image_size=16)
    with pytest.raises(ValueError, match="position table is for 16x16"):
        model(torch.zeros(1, 20, 20, 3))


def test_bert_token_types_default_to_zero():
    model = T.BertEncoder(T.bert_base_config(dtype=torch.float32, **BERT))
    model.reset_parameters(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(bert_batch(0)["x"])
    with torch.no_grad():
        a = model(tokens)["logits"]
        b = model(tokens, torch.zeros_like(tokens))["logits"]
        c = model(tokens, torch.ones_like(tokens))["logits"]
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("rows", [2, 64], ids=["type_table", "token_table"])
def test_lookup_is_the_embedding_and_its_gradient(rows):
    """`transformer.lookup`, every embedding of the port: on the CPU it is
    `F.embedding`, forward and backward; the form the card runs (advanced
    indexing, whose backward sums each row's cotangents in token order)
    gives the same rows and the same table gradient within f32 rounding,
    BERT's all-zero token types included."""
    rng = np.random.RandomState(0)
    table = torch.tensor(rng.randn(rows, 16).astype(np.float32))
    tokens = torch.tensor(rng.randint(0, rows, (4, 32)), dtype=torch.int32)
    if rows == 2:
        tokens = torch.zeros_like(tokens)
    cot = torch.tensor(rng.randn(4, 32, 16).astype(np.float32))

    def grad(fn):
        leaf = table.clone().requires_grad_()
        out = fn(leaf)
        out.backward(cot)
        return out.detach(), leaf.grad

    got = grad(lambda t: T.lookup(t, tokens))
    ref = grad(lambda t: torch.nn.functional.embedding(tokens, t))
    card = grad(lambda t: t[tokens])
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(card[0], ref[0])
    torch.testing.assert_close(card[1], ref[1], rtol=1e-6, atol=1e-5)
