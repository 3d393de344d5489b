"""The port's pipeline-parallel LM (`models/pipeline_lm.py` over
`parallel/pipeline.py`) against the JAX package's `PipelinedTransformerLM`.

Every case draws the JAX model's params from a seed and the tokens with
numpy; the port's ranks load their stage through `convert.
pipeline_from_flax` and run in one 4-rank gloo world
(`torch_dist_worker.py`): the pp 4 cases over {"pp": 4}, the pp 2 cases
over {"dp": 2, "pp": 2}, so each of them runs on two dp lines at once (the
batch replicated over dp, as JAX's `shard_map` gives x the spec P()). JAX
runs on the same mesh of virtual CPU devices.  All f32:

  * logits and losses within LOSS_ATOL (1e-5) of JAX's: `apply`,
    `loss_gpipe`, `loss_1f1b` through the fused loop, and at pp 4
    `loss_1f1b_primal` (GPipe's forward, the head per microbatch, under
    autograd: the card's reference for 1F1B) against JAX's `loss_1f1b`;
  * every stage and head gradient, gathered over the pp ranks into flax
    layout (`convert.pipeline_to_flax`), within GRAD_RTOL (1e-4) of the
    leaf's largest |JAX value| of `jax.grad` of the same schedule, plus
    GRAD_ATOL (1e-8) for the key biases, whose gradient is zero in exact
    arithmetic (softmax ignores a shift) and f32 rounding (~1e-11) here;
  * both dp lines bit-equal, the head's gradients equal on every rank;
  * three SGD steps through each schedule with JAX's losses;
  * the in-process run (`*_all_ranks`: every rank in this process,
    which `chip_smoke.py` runs on the card) bit-equal to the group run;
  * a 1F1B whose invalid forwards overwrite their slot (a planted fault)
    off JAX's gradients by more than the rule, at pp 4 where cool-down
    forwards on ranks 1 and 2 land before the last microbatch's backward;
  * the constructor and schedule errors with JAX's messages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import transformer as J
from tf_operator_tpu.models.pipeline_lm import PipelinedTransformerLM as JPL
from tf_operator_tpu.parallel import pipeline as j_pipeline
from tf_operator_tpu.parallel.mesh import build_mesh as j_build_mesh
from tf_operator_tpu_torch.models import pipeline_lm as PL
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models.convert import (pipeline_from_flax,
                                                  pipeline_to_flax)
from tf_operator_tpu_torch.parallel import pipeline as pipeline_mod
from tf_operator_tpu_torch.parallel.mesh import build_mesh
from torch_dist_worker import World

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-8
SMALL = dict(vocab_size=64, num_layers=4, num_heads=2, d_model=32, d_ff=64,
             max_len=16)
LLAMA = dict(SMALL, num_kv_heads=1)
BATCH = 8
SGD_LR = 0.05
SGD_STEPS = 3

# name: (config preset, its overrides, pp, dp, microbatches, virtual
# stages, schedules, SGD schedule)
CASES = {
    "pp2": ("TransformerConfig", SMALL, 2, 2, 2, 1, ("gpipe", "1f1b"), None),
    # M 8 > 2P: the 1F1B slots wrap around
    "pp2_wrap": ("TransformerConfig", SMALL, 2, 2, 8, 1, ("gpipe", "1f1b"),
                 None),
    # more microbatches than stages, the pp4 dryrun's seam
    # 1F1B's primal under autograd against JAX's loss_1f1b gradient
    "pp4": ("TransformerConfig", SMALL, 4, 1, 8, 1,
            ("gpipe", "1f1b", "1f1b_primal"), None),
    "pp2_interleaved": ("TransformerConfig", SMALL, 2, 2, 2, 2, ("gpipe",),
                        None),
    "llama_pp2": ("llama_style_config", LLAMA, 2, 2, 2, 1,
                  ("gpipe", "1f1b"), None),
    "sgd_gpipe": ("TransformerConfig", SMALL, 2, 2, 2, 1, (), "gpipe"),
    "sgd_1f1b": ("TransformerConfig", SMALL, 2, 2, 4, 1, (), "1f1b"),
}
SCHEDULE_CASES = [(name, s) for name, case in CASES.items()
                  for s in case[6]]


def jax_model(name):
    preset, config, pp, dp, m, virtual = CASES[name][:6]
    axes = {"dp": dp, "pp": pp} if dp > 1 else {"pp": pp}
    mesh = j_build_mesh(axes, devices=jax.devices()[:dp * pp])
    cfg = getattr(J, preset)(dtype=jnp.float32, **config)
    return JPL(cfg, mesh, num_microbatches=m, virtual_stages=virtual)


def tokens_for(seed):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], (BATCH, SMALL["max_len"])).astype(np.int32)


def port_models(name, params):
    """Every rank's module of the case, in this process."""
    preset, config, pp, _, m, virtual = CASES[name][:6]
    cfg = getattr(T, preset)(dtype=torch.float32, **config)
    layout = build_mesh({"pp": pp}, world_size=pp)
    models = []
    for rank in range(pp):
        model = PL.PipelinedTransformerLM(cfg, layout, num_microbatches=m,
                                          virtual_stages=virtual,
                                          pp_rank=rank)
        model.load_state_dict(pipeline_from_flax(params, rank, pp, virtual))
        models.append(model)
    return models


def grads_of(models):
    return [{n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in m.named_parameters()} for m in models]


def jax_reference(name, model, params, tokens):
    sharded = model.shard_params(params)
    out = {"logits": np.asarray(jax.jit(model.apply)(sharded, tokens))}
    for schedule in CASES[name][6]:
        loss, grads = jax.jit(jax.value_and_grad(getattr(
            model, f"loss_{schedule.removesuffix('_primal')}")))(sharded,
                                                                 tokens)
        out[schedule] = (float(loss), jax.device_get(grads))
    sgd = CASES[name][7]
    if sgd:
        step = jax.jit(lambda p: jax.value_and_grad(
            getattr(model, f"loss_{sgd}"))(p, tokens))
        losses = []
        for _ in range(SGD_STEPS):
            loss, grads = step(sharded)
            sharded = jax.tree_util.tree_map(lambda a, g: a - SGD_LR * g,
                                             sharded, grads)
            losses.append(float(loss))
        out["sgd"] = losses
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank world's results, started first; meanwhile JAX's and the
    in-process run's."""
    setup = {}
    cases = []
    for seed, name in enumerate(CASES):
        preset, config, pp, dp, m, virtual, schedules, sgd = CASES[name]
        model = jax_model(name)
        params = jax.device_get(model.init(jax.random.PRNGKey(seed)))
        tokens = tokens_for(seed)
        setup[name] = (model, params, tokens)
        cases.append(dict(
            name=name, preset=preset,
            config=dict(config, dtype=torch.float32),
            mesh={"dp": 4 // pp, "pp": pp} if pp < 4 else {"pp": 4},
            microbatches=m, virtual=virtual, schedules=schedules,
            params=params, tokens=torch.from_numpy(tokens).long(),
            sgd_steps=SGD_STEPS if sgd else 0, sgd_schedule=sgd, lr=SGD_LR))
    world = World(tmp_path_factory.mktemp("pipeline"), 4,
                  dict(kind="pipeline", cases=cases))
    jax_out = {name: jax_reference(name, *setup[name]) for name in CASES}
    local = {}
    for name, (_, params, tokens) in setup.items():
        models = port_models(name, params)
        tt = torch.from_numpy(tokens).long()
        for schedule in CASES[name][6]:
            for m in models:
                m.zero_grad(set_to_none=True)
            fn = getattr(PL, f"loss_{schedule}_all_ranks")
            loss = fn(models, tt)
            loss.backward()
            local[name, schedule] = (loss.detach(), grads_of(models))
    ranks = world.results()
    return dict(jax=jax_out, local=local, setup=setup,
                ranks={name: [r[name] for r in ranks] for name in CASES})


def lines(results):
    """{dp line: [its ranks' results in pp order]}."""
    out = {}
    for r in sorted(results, key=lambda r: (int(r["dp"]), int(r["pp"]))):
        out.setdefault(int(r["dp"]), []).append(r)
    return out


def assert_grads_close(got, want, rtol=GRAD_RTOL):
    """Per leaf: max |got - want| <= rtol * max |want| + GRAD_ATOL."""
    flat_w, tree = jax.tree_util.tree_flatten_with_path(want)
    flat_g = tree.flatten_up_to(got)
    for (path, w), g in zip(flat_w, flat_g):
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape, path
        err = float(np.abs(g - w).max())
        limit = rtol * float(np.abs(w).max()) + GRAD_ATOL
        assert err <= limit, (jax.tree_util.keystr(path), err, limit)


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_jax(runs, name):
    want = runs["jax"][name]["logits"]
    for rank in runs["ranks"][name]:
        np.testing.assert_allclose(rank["logits"].numpy(), want,
                                   atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("name,schedule", SCHEDULE_CASES)
def test_loss_and_grads_match_jax(runs, name, schedule):
    loss, grads = runs["jax"][name][schedule]
    virtual = CASES[name][5]
    for line in lines(runs["ranks"][name]).values():
        for rank in line:
            assert abs(float(rank[schedule]["loss"]) - loss) <= LOSS_ATOL
        head = {n: g for n, g in line[0][schedule]["grads"].items()
                if not n.startswith("blocks.")}
        for rank in line[1:]:  # the replicated head's gradients
            for n, g in head.items():
                assert torch.equal(rank[schedule]["grads"][n], g), n
        assert_grads_close(pipeline_to_flax(
            [r[schedule]["grads"] for r in line], virtual), grads)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[3] > 1])
def test_dp_lines_are_bit_equal(runs, name):
    first, other = lines(runs["ranks"][name]).values()
    for a, b in zip(first, other):
        assert torch.equal(a["logits"], b["logits"])
        assert torch.equal(a["sgd"], b["sgd"])
        for schedule in CASES[name][6]:
            assert torch.equal(a[schedule]["loss"], b[schedule]["loss"])
            for n, g in a[schedule]["grads"].items():
                assert torch.equal(b[schedule]["grads"][n], g), n


@pytest.mark.parametrize("name", ["sgd_gpipe", "sgd_1f1b"])
def test_sgd_steps_match_jax(runs, name):
    want = runs["jax"][name]["sgd"]
    assert want[-1] < want[0]
    for rank in runs["ranks"][name]:
        np.testing.assert_allclose(rank["sgd"].numpy(), want, atol=LOSS_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("name,schedule", SCHEDULE_CASES)
def test_in_process_run_equals_the_group_run(runs, name, schedule):
    """Every rank in one process (the ring's hops as hand-overs) gives the
    group run's loss and gradients bit for bit; the head's are rank 0's."""
    loss, grads = runs["local"][name, schedule]
    line = lines(runs["ranks"][name])[0]
    assert torch.equal(line[0][schedule]["loss"], loss)
    for rank, (mine, want) in enumerate(zip(grads, line)):
        for n, g in want[schedule]["grads"].items():
            if rank and not n.startswith("blocks."):
                continue
            assert torch.equal(mine[n], g), (rank, n)


def test_planted_slot_overwrite_fails(runs, monkeypatch):
    """A 1F1B whose invalid (warm-up, cool-down) forwards write their
    clipped slot: at pp 4 ranks 1 and 2 overwrite the last microbatch's
    kept input with a zero before its backward, and the gradients leave
    the rule."""
    def overwrite(kept, slots, f, valid, inp):
        kept[f % slots] = inp

    _, params, tokens = runs["setup"]["pp4"]
    monkeypatch.setattr(pipeline_mod, "_save_input", overwrite)
    models = port_models("pp4", params)
    loss = PL.loss_1f1b_all_ranks(models, torch.from_numpy(tokens).long())
    loss.backward()
    want_loss, want = runs["jax"]["pp4"]["1f1b"]
    # the forward's loss is untouched; the backward's recompute is not
    assert abs(float(loss.detach()) - want_loss) <= LOSS_ATOL
    with pytest.raises(AssertionError):
        assert_grads_close(pipeline_to_flax(grads_of(models)), want)


def _errors(fn_jax, fn_port):
    with pytest.raises(ValueError) as theirs:
        fn_jax()
    with pytest.raises(ValueError) as ours:
        fn_port()
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("what", ["layers", "interleaved_microbatches"])
def test_constructor_errors_are_jax_messages(what):
    layers, m, virtual = {"layers": (3, 4, 1),
                          "interleaved_microbatches": (4, 4, 2)}[what]
    mesh = j_build_mesh({"pp": 2}, devices=jax.devices()[:2])
    config = dict(SMALL, num_layers=layers)
    _errors(lambda: JPL(J.TransformerConfig(dtype=jnp.float32, **config),
                        mesh, num_microbatches=m, virtual_stages=virtual),
            lambda: PL.PipelinedTransformerLM(
                T.TransformerConfig(dtype=torch.float32, **config),
                build_mesh({"pp": 2}, world_size=2), num_microbatches=m,
                virtual_stages=virtual, pp_rank=0))


def test_schedule_errors_are_jax_messages(runs):
    jmodel, params, tokens = runs["setup"]["pp2_interleaved"]
    models = port_models("pp2_interleaved", params)
    tt = torch.from_numpy(tokens).long()
    # 1F1B with virtual stages
    _errors(lambda: jmodel.loss_1f1b(jmodel.shard_params(params), tokens),
            lambda: PL.loss_1f1b_all_ranks(models, tt))
    # a batch the microbatches do not divide
    _errors(lambda: j_pipeline._split_microbatches(jnp.zeros((5, 4)), 3),
            lambda: pipeline_mod.split_microbatches(torch.zeros(5, 4), 3))
    # the interleaved schedule with more microbatches than stages
    _errors(lambda: j_pipeline.gpipe_interleaved(
                lambda p, x: x, {"w": jnp.zeros((2, 2, 1))},
                jnp.zeros((4, 4)), jmodel.mesh, 4),
            lambda: pipeline_mod.gpipe_interleaved(
                [[lambda x: x] * 2] * 2, torch.zeros(4, 4), 4,
                pipeline_mod.LocalRing(2)))
