"""ViT and BERT under tensor and sequence parallelism, and ZeRO composed
with fsdp on the three transformers, against the one-process port and
the JAX package.

Layouts (no processes, meta tensors): for the LM (GPT-small), ViT-B/16 and
BERT-base under {"tp": 2}, {"sp": 2} and {"dp": 2, "fsdp": 2}, every
port parameter's layout mapped back onto the flax dims is the JAX
`combined_spec` (BERT's token embedding cut by vocabulary, the rest of the
encoders' own leaves replicated); the ZeRO plan's JSON under
{"dp": 2, "fsdp": 2}, {"dp": 2, "tp": 2} and {"dp": 2, "sp": 2} is JAX's
byte for byte, and under fsdp the plan's dp dim on the query and out
kernels is their head_dim, which the port slices on the view that splits
its merged [heads * head_dim].

Training (one 4-rank gloo world, `torch_dist_worker.py`,
`torch.set_num_threads(1)`): ViT (2 layers, d 64, 2 heads, 20x20 images in
patches of 4: T 26, 10 classes) and BERT (2 layers, d 64, 2 heads, vocab
128, T 16, 2 labels), f32, take 3 `adamw` steps (lr 1e-3) on a global batch
of 8 from the same flax params under {"dp": 2, "tp": 2}, {"dp": 2, "sp":
2} and {"dp": 2, "fsdp": 2} + ZeRO; the LM (2 layers, d 64, 2 heads,
vocab 128, T 16) takes 3 steps of the LM recipe under {"dp": 2, "fsdp": 2}
+ ZeRO; BERT takes 3 steps at grad_accum 2 under {"dp": 2, "sp": 2}.
tp and sp each run beside a dp axis because a world of 4 ranks is laid
out whole.  The one-process port runs the global batch, and the JAX
package the same mesh of virtual CPU devices (its ring attention under
sp, its ZeRO-wrapped optimizer).  Losses agree within 5e-5 relative at
every step, and every parameter within 1e-4 of its largest magnitude
(at least 1), the key biases aside (their gradient is zero in exact
arithmetic and Adam turns the rounding residue into steps of up to lr:
ROADMAP §C).  A checkpoint saved under each of those meshes restores in
a plain run, and four of them under another mesh, whose next step is the
unbroken one-process run's.  A ViT
whose tokens sp does not divide exits 2 naming the rule, and the JAX ring
refuses the same shape.
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import transformer as JT
from tf_operator_tpu.models import vit as JV
from tf_operator_tpu.parallel.mesh import build_mesh as j_build_mesh
from tf_operator_tpu.parallel.ring_attention import \
    ring_attention as j_ring_attention
from tf_operator_tpu.parallel.tp_rules import combined_spec as j_combined
from tf_operator_tpu.parallel.tp_rules import make_param_shardings
from tf_operator_tpu.train import optim as joptim
from tf_operator_tpu.train import zero as jzero
from tf_operator_tpu.train.state import create_train_state as j_create
from tf_operator_tpu.train.step import classification_loss_fn as j_cls_loss
from tf_operator_tpu.train.step import lm_loss_fn as j_lm_loss
from tf_operator_tpu.train.step import make_train_step as j_make_step
from tf_operator_tpu.train.step import shard_batch as j_shard_batch
from tf_operator_tpu.train.step import shard_train_state
from tf_operator_tpu_torch.models import convert
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models import vit as V
from tf_operator_tpu_torch.parallel.mesh import build_mesh
from tf_operator_tpu_torch.parallel.tp_rules import param_layouts
from tf_operator_tpu_torch.train import data as tdata
from tf_operator_tpu_torch.train import optim as toptim
from tf_operator_tpu_torch.train import zero as tzero
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
from tf_operator_tpu_torch.train.state import create_train_state
from tf_operator_tpu_torch.train.step import (classification_loss_fn,
                                              lm_loss_fn, make_train_step)
from tf_operator_tpu_torch.workloads import vit as vit_workload
from torch_dist_worker import World

torch.set_num_threads(1)

LOSS_RTOL = 5e-5
PARAM_RTOL = 1e-4

# ---------------------------------------------------------------------------
# layouts and plans at full width (meta tensors, eval_shape)

LAYOUT_MESHES = [{"tp": 2}, {"sp": 2}, {"dp": 2, "fsdp": 2}]
PLAN_MESHES = [{"dp": 2, "fsdp": 2}, {"dp": 2, "tp": 2}, {"dp": 2, "sp": 2}]


def _flat(tree):
    return {tuple(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _full_width(name):
    """(the port model on meta tensors, the JAX params' shapes)."""
    with torch.device("meta"):
        port = {"lm": lambda: T.TransformerLM(T.gpt_small_config()),
                "vit": lambda: V.ViT(V.vit_base_config(max_len=197)),
                "bert": lambda: T.BertEncoder(T.bert_base_config())}[name]()
    jmodel, example = {
        "lm": (JT.TransformerLM(JT.gpt_small_config()),
               jnp.zeros((1, 8), jnp.int32)),
        "vit": (JV.ViT(JV.vit_base_config(max_len=197)),
                jnp.zeros((1, 224, 224, 3))),
        "bert": (JT.BertEncoder(JT.bert_base_config()),
                 jnp.zeros((1, 8), jnp.int32))}[name]
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                example))["params"]
    return port, shapes


def _mesh_pair(axes):
    n = int(np.prod(list(axes.values())))
    return build_mesh(axes, n), j_build_mesh(axes, devices=jax.devices()[:n])


@pytest.mark.parametrize("name", ["lm", "vit", "bert"])
@pytest.mark.parametrize("axes", LAYOUT_MESHES,
                         ids=[json.dumps(a) for a in LAYOUT_MESHES])
def test_layout_maps_back_to_the_jax_combined_spec(name, axes):
    port, shapes = _full_width(name)
    mesh, jmesh = _mesh_pair(axes)
    want = {path: tuple(j_combined("/".join(path), leaf.shape, jmesh))
            for path, leaf in _flat(shapes).items()}
    layouts = param_layouts(port, mesh)
    assert {lay.path for lay in layouts.values()} == set(want)
    for lay in layouts.values():
        held = {axis: dim for axis, dim in (("tp", lay.tp_dim),
                                            ("fsdp", lay.fsdp_dim))
                if dim is not None}
        assert lay.flax_spec(held, mesh) == want[lay.path], lay.name
        assert lay.spec == want[lay.path], lay.name
    if axes == {"tp": 2} and name == "bert":
        # the token embedding by vocabulary; the encoder's own leaves whole
        assert layouts["tok_emb.weight"].tp_dim == 0
        for n in ("type_emb.weight", "pos_emb", "pooler.weight",
                  "classifier.weight", "emb_ln.weight"):
            assert layouts[n].spec == (), n
    if axes == {"tp": 2} and name == "vit":
        for n in ("patch_embed.weight", "cls_token", "pos_emb",
                  "head.weight", "ln_f.weight"):
            assert layouts[n].spec == (), n


@pytest.mark.parametrize("name", ["lm", "vit", "bert"])
@pytest.mark.parametrize("axes", PLAN_MESHES,
                         ids=[json.dumps(a) for a in PLAN_MESHES])
def test_zero_plan_json_is_the_jax_plan(name, axes):
    port, shapes = _full_width(name)
    mesh, jmesh = _mesh_pair(axes)
    ours = tzero.plan_for_model(port, mesh)
    theirs = jzero.build_zero_plan(
        shapes, jmesh, base_specs=make_param_shardings(shapes, jmesh))
    assert ours.to_json() == theirs.to_json()
    layouts = param_layouts(port, mesh, ours)
    split = {n for n, lay in layouts.items() if lay.zero_split is not None}
    if "fsdp" in axes:
        # dp lands on head_dim of every query/key/value and out kernel
        kernels = {n for n in layouts if n.endswith(
            ("query.weight", "key.weight", "value.weight", "out.weight"))
            and ".attn." in n}
        assert split == kernels and kernels
        for n in kernels:
            lay = layouts[n]
            entry = ours.match(lay.path, lay.flax_shape)
            assert lay.flax_shape[entry.dim] == 64  # head_dim
    else:
        assert not split


def test_a_head_dim_has_no_single_port_dim_outside_zero():
    """`port_dim` still raises for a flax dim inside the merged
    [heads * head_dim]; only the ZeRO slice takes the split view."""
    port, _ = _full_width("bert")
    mesh = build_mesh({"dp": 2, "fsdp": 2}, 4)
    lay = param_layouts(port, mesh)["blocks.0.attn.query.weight"]
    with pytest.raises(ValueError, match="no single dim"):
        lay.port_dim(2)
    assert lay.view_dim(2) == (1, (0, 64))
    assert lay.view_dim(0) == (1, None)


# ---------------------------------------------------------------------------
# 3 steps over a 4-rank gloo world against one process and JAX

LR = 1e-3
VIT = dict(num_layers=2, num_heads=2, d_model=64, d_ff=128, max_len=26)
VIT_BUILD = dict(num_classes=10, patch_size=4, image_size=20)
BERT = dict(num_layers=2, num_heads=2, d_model=64, d_ff=128, max_len=16,
            vocab_size=128)
BERT_BUILD = dict(num_labels=2)
LM = dict(num_layers=2, num_heads=2, d_model=64, d_ff=128, max_len=16,
          vocab_size=128)
LM_OPT = dict(schedule="cosine", warmup_steps=1, total_steps=5,
              weight_decay=0.1, grad_clip=1.0)
LM_LR = 3e-3
# name -> (model, mesh, zero, grad_accum)
CASES = {
    **{f"{model}_{tag}": (model, axes, zero, 1)
       for model in ("vit", "bert")
       for tag, axes, zero in (("dp2_tp2", {"dp": 2, "tp": 2}, False),
                               ("dp2_sp2", {"dp": 2, "sp": 2}, False),
                               ("dp2_fsdp2_zero", {"dp": 2, "fsdp": 2},
                                True))},
    "bert_dp2_sp2_accum2": ("bert", {"dp": 2, "sp": 2}, False, 2),
    "lm_dp2_fsdp2_zero": ("lm", {"dp": 2, "fsdp": 2}, True, 1),
}
# the encoder cases whose state is saved after their steps; some restore it
# under another mesh and take a fourth step there: name -> (mesh, zero)
CKPT_CASES = [n for n, c in CASES.items() if c[0] != "lm" and c[3] == 1]
RESUME_TO = {"vit_dp2_tp2": ({"dp": 2, "fsdp": 2}, True),
             "bert_dp2_tp2": ({"dp": 2, "fsdp": 2}, True),
             "vit_dp2_fsdp2_zero": ({"dp": 2, "sp": 2}, False),
             "bert_dp2_fsdp2_zero": ({"dp": 2, "tp": 2}, False)}
# SGD moves each parameter by lr times its gradient, so a gradient summed
# the wrong number of times over tp or sp shows (Adam's per-element
# scaling would hide a whole tensor's): name -> (model, mesh)
SGD_LR = 0.05
SGD_CASES = {f"{model}_{tag}_sgd": (model, axes)
             for model in ("vit", "bert")
             for tag, axes in (("dp2_tp2", {"dp": 2, "tp": 2}),
                               ("dp2_sp2", {"dp": 2, "sp": 2}))}


def _batches(model):
    if model == "lm":
        return [{"tokens": b["tokens"]} for b, _ in
                zip(tdata.synthetic_tokens(8, 17, 128, seed=1), range(3))]
    out = []
    for seed in (1, 2, 3):
        rng = np.random.RandomState(seed)
        x = (rng.randn(8, 20, 20, 3).astype(np.float32) if model == "vit"
             else rng.randint(0, 128, (8, 16)).astype(np.int32))
        labels = 10 if model == "vit" else 2
        out.append({"x": x,
                    "label": rng.randint(0, labels, 8).astype(np.int32)})
    return out


def _jax_model(model, mesh=None):
    if model == "vit":
        return JV.ViT(JV.vit_base_config(dtype=jnp.float32, mesh=mesh, **VIT),
                      num_classes=10, patch_size=4)
    if model == "bert":
        return JT.BertEncoder(JT.bert_base_config(dtype=jnp.float32,
                                                  mesh=mesh, **BERT),
                              num_labels=2)
    return JT.TransformerLM(JT.gpt_small_config(dtype=jnp.float32, mesh=mesh,
                                                **LM))


def _apply(jmodel):
    def apply(variables, x, **kw):
        out = jmodel.apply(variables, x, **kw)
        return out["logits"] if isinstance(out, dict) else out
    return apply


FROM_FLAX = {"vit": convert.vit_from_flax, "bert": convert.bert_from_flax,
             "lm": convert.params_from_flax}


def _flax_init(model):
    example = _batches(model)[0]
    example = example["tokens"][:, :-1] if model == "lm" else example["x"]
    return jax.device_get(_jax_model(model).init(jax.random.PRNGKey(0),
                                                 example)["params"])


def jax_run(model, axes, zero, accum, init):
    """The JAX package's losses and params (port layout) under the mesh."""
    n = int(np.prod(list(axes.values())))
    mesh = j_build_mesh(axes, devices=jax.devices()[:n])
    jmodel = _jax_model(model, mesh)
    plan = (jzero.build_zero_plan(
        init, mesh, base_specs=make_param_shardings(init, mesh))
        if zero else None)
    if model == "lm":
        tx = joptim.lm_optimizer(LM_LR, **LM_OPT, zero_plan=plan,
                                 mesh=mesh if zero else None)
        loss_fn = j_lm_loss(jmodel.apply)
        example = jnp.zeros((2, 16), jnp.int32)
    else:
        tx = optax.adamw(LR)
        if zero:
            tx = jzero.zero_shard_optimizer(tx, plan, mesh)
        loss_fn = j_cls_loss(_apply(jmodel))
        example = _batches(model)[0]["x"][:2]
    state = j_create(jax.random.PRNGKey(0), _jax_model(model), tx, example,
                     zero_plan=plan)
    state = shard_train_state(state.replace(params=init), mesh,
                              zero_plan=plan)
    step = j_make_step(loss_fn, donate=False, grad_accum=accum)
    losses = []
    for batch in _batches(model):
        state, metrics = step(state, j_shard_batch(batch, mesh))
        losses.append(float(metrics["loss"]))
    return losses, FROM_FLAX[model](jax.device_get(state.params))


def _port_model(model):
    if model == "vit":
        return V.ViT(V.vit_base_config(dtype=torch.float32, **VIT),
                     **VIT_BUILD)
    if model == "bert":
        return T.BertEncoder(T.bert_base_config(dtype=torch.float32, **BERT),
                             **BERT_BUILD)
    return T.TransformerLM(T.gpt_small_config(dtype=torch.float32, **LM))


def port_run(model, init, steps=3, state=None, sgd=False):
    """The one-process port on the global batches (`steps` of them, or,
    given a `state`, the batches after its step)."""
    if state is None:
        m = _port_model(model)
        m.load_state_dict(init)
        recipe = (toptim.lm_optimizer(LM_LR, **LM_OPT) if model == "lm"
                  else toptim.sgd(SGD_LR) if sgd else toptim.adamw(LR))
        state = create_train_state(m, recipe, seed=None)
    loss_fn = (lm_loss_fn(state.model) if model == "lm"
               else classification_loss_fn(state.model))
    step = make_train_step(loss_fn)
    losses = []
    batches = _batches(model) + _batches(model)[:1]
    for batch in batches[state.step:steps]:
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    return losses, state


def _job(name, model, axes, zero, accum, init, ckpt=None, sgd=False,
         resume=None):
    if model == "lm":
        return dict(name=name, kind="shard", mesh=axes,
                    preset="gpt_small_config",
                    config=dict(dtype=torch.float32, **LM), init=init,
                    opt=dict(peak_lr=LM_LR, **LM_OPT), zero=zero,
                    batches=[torch.from_numpy(b["tokens"])
                             for b in _batches(model)])
    return dict(name=name, model=model, mesh=axes, zero=zero,
                grad_accum=accum, lr=SGD_LR if sgd else LR, sgd=sgd,
                init=init, ckpt=ckpt, resume=resume and dict(
                    mesh=resume[0], zero=resume[1]),
                resume_batch={k: torch.from_numpy(v)
                              for k, v in _batches(model)[0].items()},
                config=VIT if model == "vit" else BERT,
                build=VIT_BUILD if model == "vit" else BERT_BUILD,
                batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                         for b in _batches(model)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's results per case, the world started first; meanwhile
    the one-process port's and JAX's."""
    flax = {m: _flax_init(m) for m in ("vit", "bert", "lm")}
    init = {m: FROM_FLAX[m](flax[m]) for m in flax}
    ckpt = tmp_path_factory.mktemp("ckpt")
    jobs = [_job(name, model, axes, zero, accum, init[model],
                 ckpt=str(ckpt / name) if name in CKPT_CASES else None,
                 resume=RESUME_TO.get(name))
            for name, (model, axes, zero, accum) in CASES.items()]
    jobs += [_job(name, model, axes, False, 1, init[model], sgd=True)
             for name, (model, axes) in SGD_CASES.items()]
    world = World(tmp_path_factory.mktemp("world4"), 4,
                  dict(kind="encoder", cases=jobs))
    port = {m: port_run(m, init[m]) for m in flax}
    sgd = {m: port_run(m, init[m], sgd=True) for m in ("vit", "bert")}
    out = {"sgd": {m: (losses, state.model.state_dict())
                   for m, (losses, state) in sgd.items()},"port": {m: (losses, {k: v.clone() for k, v in
                                 state.model.state_dict().items()})
                    for m, (losses, state) in port.items()},
           "jax": {name: jax_run(model, axes, zero, accum, flax[model])
                   for name, (model, axes, zero, accum) in CASES.items()},
           "init": init, "ckpt": ckpt}
    # the unbroken one-process run's fourth step (the first batch again)
    out["port4"] = {}
    for m in ("vit", "bert"):
        losses, state = port_run(m, None, steps=4, state=port[m][1])
        out["port4"][m] = (losses, state.model.state_dict())
    results = world.results(timeout=300)
    out["ranks"] = {case["name"]: [r[case["name"]] for r in results]
                    for case in jobs}
    return out


def _close(got_losses, got_params, want, init):
    losses, params = want
    np.testing.assert_allclose(got_losses, losses, rtol=LOSS_RTOL, atol=0)
    moved = 0.0
    for key, value in params.items():
        if key.endswith("key.bias"):
            continue
        atol = PARAM_RTOL * max(1.0, float(value.abs().max()))
        torch.testing.assert_close(got_params[key], value, atol=atol,
                                   rtol=0, msg=key)
        moved = max(moved, float((value - init[key]).abs().max()))
    assert moved > 10 * PARAM_RTOL  # the steps moved the parameters


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_one_process_and_jax(runs, name, against):
    model = CASES[name][0]
    want = (runs["port"][model] if against == "one_process"
            else runs["jax"][name])
    for rank in runs["ranks"][name]:
        _close(rank["losses"].numpy(), rank["params"], want,
               runs["init"][model])


@pytest.mark.parametrize("name", list(SGD_CASES))
def test_sgd_steps_match_one_process(runs, name):
    model = SGD_CASES[name][0]
    for rank in runs["ranks"][name]:
        _close(rank["losses"].numpy(), rank["params"], runs["sgd"][model],
               runs["init"][model])


ENCODER_CASES = {**{n: c[:2] for n, c in CASES.items() if c[0] != "lm"},
                 **SGD_CASES}


@pytest.mark.parametrize("name", list(ENCODER_CASES))
def test_blocks_see_their_slice_of_the_sequence(runs, name):
    """Under sp the blocks run on 1/sp of the tokens (ViT's patches + CLS
    cut after the embedding, BERT's tokens by the batch's shard); every
    other mesh gives them the whole sequence."""
    model, axes = ENCODER_CASES[name]
    whole = 26 if model == "vit" else 16
    for rank in runs["ranks"][name]:
        assert int(rank["seq"]) == whole // axes.get("sp", 1)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_piece(runs, name):
    """Every rank's parameters and moments are its layout's share of the
    whole (under ZeRO, 1/dp of every entry the plan shards, a head_dim
    entry on its split view), and the layout it holds is the JAX spec."""
    model, axes, zero, _ = CASES[name]
    mesh = build_mesh(axes, 4)
    with torch.device("meta"):
        m = _port_model(model)
    plan = tzero.plan_for_model(m, mesh) if zero else None
    layouts = param_layouts(m, mesh, plan)
    full = {n: p.numel() for n, p in m.named_parameters()}
    for rank in runs["ranks"][name]:
        for n, lay in layouts.items():
            split = 1
            for axis, dim in (("tp", lay.tp_dim), ("fsdp", lay.fsdp_dim)):
                if dim is not None:
                    split *= axes[axis]
            assert int(rank["local_params"][n]) == full[n] // split, n
            if lay.zero_dim is not None:
                split *= axes["dp"]
            assert int(rank["local_moments"][n]) == full[n] // split, n
            assert rank["held"][n] == lay.spec, n
        if model != "lm":
            want = sorted(n for n, lay in layouts.items()
                          if lay.zero_split is not None)
            assert rank["split"] == want and bool(want) == zero


@pytest.mark.parametrize("name", CKPT_CASES)
def test_checkpoint_restores_in_a_plain_run(runs, name):
    """The whole state saved under the case's mesh (tp slices, sp, or
    fsdp shards with ZeRO slices on the split head_dim view) loads into a
    plain one-process state: its parameters are the ranks' gathered ones,
    and its next step (moments included) is the unbroken run's fourth."""
    model = CASES[name][0]
    m = _port_model(model)
    state = create_train_state(m, toptim.adamw(LR))
    mgr = CheckpointManager(str(runs["ckpt"] / name))
    state = mgr.restore(state)
    mgr.close()
    assert state.step == 3
    for key, value in runs["ranks"][name][0]["params"].items():
        assert torch.equal(m.state_dict()[key], value), key
    losses, _ = port_run(model, None, steps=4, state=state)
    np.testing.assert_allclose(losses, runs["port4"][model][0][-1:],
                               rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("name", list(RESUME_TO))
def test_checkpoint_resumes_under_another_mesh(runs, name):
    """The state saved under the case's mesh restores under RESUME_TO's
    (each rank cutting its piece: tp slices, fsdp shards, ZeRO slices on
    the split view), whose fourth step is the unbroken run's."""
    model = CASES[name][0]
    losses, params = runs["port4"][model]
    for rank in runs["ranks"][name]:
        assert int(rank["restored_step"]) == 3
        _close(rank["resumed_loss"].numpy()[None], rank["resumed_params"],
               (losses[-1:], params), runs["init"][model])


def test_vit_tokens_that_sp_does_not_divide_exit_2(monkeypatch, capsys):
    """16 patches + CLS over sp 2: the workload refuses before joining a
    group, and the JAX ring refuses the same T."""
    for key, value in {"TPUJOB_FORCE_PLATFORM": "cpu",
                       "TPUJOB_NUM_PROCESSES": "2", "TPUJOB_PROCESS_ID": "0",
                       "TPUJOB_COORDINATOR_ADDRESS": "127.0.0.1:1",
                       "TPUJOB_MESH_SHAPE": json.dumps({"sp": 2})}.items():
        monkeypatch.setenv(key, value)
    assert vit_workload.main(["--steps", "1", "--batch", "4",
                              "--image-size", "16", "--patch-size", "4",
                              "--layers", "1", "--d-model", "64"]) == 2
    assert ("17 tokens (patches + CLS) must divide by sp=2: ring attention "
            "needs T divisible by the sp axis size") in capsys.readouterr().out
    mesh = j_build_mesh({"sp": 2}, devices=jax.devices()[:2])
    q = jnp.zeros((1, 2, 17, 32), jnp.float32)
    with pytest.raises(ValueError):
        j_ring_attention(q, q, q, mesh, causal=False)


# ---------------------------------------------------------------------------
# the workloads as 4 processes under {"dp": 2, "fsdp": 2} + ZeRO

ZERO_WORKLOADS = {
    "lm": ["--steps", "2", "--batch", "4", "--seq-len", "16", "--vocab",
           "64", "--layers", "1", "--d-model", "128"],
    "vit": ["--steps", "2", "--batch", "4", "--image-size", "16",
            "--patch-size", "4", "--layers", "1", "--d-model", "128",
            "--num-classes", "10"],
    "bert": ["--steps", "2", "--batch", "4", "--seq-len", "16", "--layers",
             "1", "--d-model", "128"],
}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def zero_logs():
    """Each workload over 4 ranks of {"dp": 2, "fsdp": 2} with the ZeRO
    knob, all started at once; every rank's log."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    procs = {}
    for name, args in ZERO_WORKLOADS.items():
        address = f"127.0.0.1:{_free_port()}"
        procs[name] = []
        for rank in range(4):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("TPUJOB_") and k != "TF_CONFIG"}
            env.update(PYTHONPATH=str(repo), OMP_NUM_THREADS="1",
                       TPUJOB_FORCE_PLATFORM="cpu", TPUJOB_NUM_PROCESSES="4",
                       TPUJOB_PROCESS_ID=str(rank),
                       TPUJOB_COORDINATOR_ADDRESS=address,
                       TPUJOB_MESH_SHAPE=json.dumps({"dp": 2, "fsdp": 2}),
                       TPUJOB_ZERO_SHARD_WEIGHT_UPDATE="1")
            procs[name].append(subprocess.Popen(
                [sys.executable, "-m",
                 f"tf_operator_tpu_torch.workloads.{name}", *args],
                cwd=str(repo), env=env, stdout=subprocess.PIPE,
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


def _jax_workload_model(name):
    """The JAX workload's model and example for ZERO_WORKLOADS' flags."""
    if name == "lm":
        return (JT.TransformerLM(JT.TransformerConfig(
            vocab_size=64, num_layers=1, num_heads=2, d_model=128, d_ff=512,
            max_len=16)), jnp.zeros((2, 16), jnp.int32))
    if name == "vit":
        return (JV.ViT(JV.vit_base_config(num_layers=1, num_heads=2,
                                          d_model=128, d_ff=512, max_len=17),
                       num_classes=10, patch_size=4),
                jnp.zeros((2, 16, 16, 3), jnp.bfloat16))
    return (JT.BertEncoder(JT.bert_base_config(
        num_layers=1, d_model=128, num_heads=2, d_ff=512, max_len=16),
        num_labels=2), jnp.zeros((2, 16), jnp.int32))


@pytest.mark.parametrize("name", list(ZERO_WORKLOADS))
def test_workload_runs_zero_with_fsdp_and_prints_the_jax_plan(
        zero_logs, capsys, name):
    """Every rank prints the JAX workload's `zero_sharding_plan:` line byte
    for byte (its query and out kernels sharded on head_dim), the loss is
    finite and rank 0 alone finishes."""
    from tf_operator_tpu.workloads import runner as j_runner

    model, example = _jax_workload_model(name)
    mesh = j_build_mesh({"dp": 2, "fsdp": 2}, devices=jax.devices()[:4])
    capsys.readouterr()
    j_runner.zero_plan_for_workload(
        j_runner.WorkloadContext(zero_shard_weight_update=True), model,
        example, mesh)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("zero_sharding_plan: ")]
    assert len(want) == 1
    plan = json.loads(want[0].split(": ", 1)[1])
    assert any(p["path"].endswith("attn/query/kernel") and p["dim"] == 2
               for p in plan["params"])
    last = {"lm": "done", "vit": "final loss", "bert": "done"}[name]
    for rank, log in enumerate(zero_logs[name]):
        lines = [ln for ln in log.splitlines()
                 if ln.startswith("zero_sharding_plan: ")]
        assert lines == want, log
        assert (last in log) == (rank == 0), log
    losses = [float(v) for v in re.findall(r"^step \d+ loss (\S+)$",
                                           zero_logs[name][0], re.M)]
    assert losses and all(np.isfinite(losses))
