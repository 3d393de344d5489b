"""The port's mixture of experts and expert parallelism against the JAX
package's.

Gating: `top_k_gating` on the same logits gives JAX's dispatch masks
exactly (dropped tokens included) and its combine weights and aux loss
within 1e-6.  The layer: `MoEMLP` from the same flax params gives JAX's
output and aux loss within 1e-5, and the same gradients.

Training: an LM with one MoE block of 4 experts (2 layers, d_model 64 = 2
heads, vocab 128, T 16, global batch 8, f32, top-2, capacity factor 0.5,
so tokens are dropped) takes 3 AdamW steps with `moe_aux_weight` 0.01 and
grad_accum 2: in one process of the port, on 2 or 4 gloo ranks
(`torch_dist_worker.py`, one world per rank count) under {"dp": 2},
{"ep": 2}, {"tp": 2}, {"sp": 2}, {"fsdp": 2}, {"dp": 2} with ZeRO and
{"dp": 2, "ep": 2}, and in the JAX package on one device on the global
batch (GSPMD keeps the JAX layer's view of the batch global).  Losses agree
within 5e-5 relative, the reported aux loss within 5e-5 and parameters
within 1e-4, the tolerances of `test_torch_shard.py`.  Each rank holds E / ep
experts.  A dp run that routes each rank's tokens alone (a planted fault)
is off by more than the tolerance.

Layouts: the expert weights' specs and the ZeRO plan's JSON at GPT-small
width with 8 experts are JAX's.  Greedy generation of an MoE config is
JAX's token for token, and the workload trains with --moe-experts over ep.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import transformer as J
from tf_operator_tpu.models.generate import generate as j_generate
from tf_operator_tpu.parallel import moe as jmoe
from tf_operator_tpu.parallel.mesh import build_mesh as j_build_mesh
from tf_operator_tpu.parallel.tp_rules import combined_spec as j_combined
from tf_operator_tpu.parallel.tp_rules import make_param_shardings
from tf_operator_tpu.train import optim as joptim
from tf_operator_tpu.train import zero as jzero
from tf_operator_tpu.train.state import create_train_state as j_create
from tf_operator_tpu.train.step import lm_loss_fn as j_loss_fn
from tf_operator_tpu.train.step import make_train_step as j_make_step
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models.convert import (params_from_flax,
                                                  params_to_flax)
from tf_operator_tpu_torch.models.generate import generate
from tf_operator_tpu_torch.parallel import moe as tmoe
from tf_operator_tpu_torch.parallel.mesh import build_mesh
from tf_operator_tpu_torch.parallel.tp_rules import param_layouts
from tf_operator_tpu_torch.train import data as tdata
from tf_operator_tpu_torch.train import optim as toptim
from tf_operator_tpu_torch.train import zero as tzero
from tf_operator_tpu_torch.train.state import create_train_state
from tf_operator_tpu_torch.train.step import lm_loss_fn, make_train_step
from torch_dist_worker import World

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 5e-5
PARAM_ATOL = 1e-4

# ---------------------------------------------------------------------------
# gating and the layer

# name -> (N, E, k, capacity, logits from a seed or a skew)
GATING = {"random_drops": (64, 8, 2, 12, None),
          "all_prefer_one": (16, 4, 1, 4, "skew"),
          "ample_capacity": (32, 4, 2, 32, None),
          "top3_tight": (48, 6, 3, 5, None)}


def _logits(n, e, kind, seed=0):
    if kind == "skew":
        out = np.zeros((n, e), np.float32)
        out[:, 0] = 10.0
        return out
    return np.random.default_rng(seed).normal(size=(n, e)).astype(np.float32)


@pytest.mark.parametrize("name", list(GATING))
def test_top_k_gating_masks_match_jax(name):
    n, e, k, cap, kind = GATING[name]
    logits = _logits(n, e, kind)
    jd, jc, jaux = jmoe.top_k_gating(jnp.asarray(logits), k, cap)
    td, tc, taux = tmoe.top_k_gating(torch.from_numpy(logits), k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
    kept = td.sum().item()
    if name in ("random_drops", "all_prefer_one", "top3_tight"):
        assert kept < n * k  # some tokens were dropped
    else:
        assert kept == n * k


def _flax_moe(d, f, e, k, cf, x):
    layer = jmoe.MoEMLP(d_model=d, d_ff=f, num_experts=e, k=k,
                        capacity_factor=cf, dtype=jnp.float32)
    params = layer.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    return layer, jax.device_get(params)


def _port_moe(d, f, e, k, cf, params):
    layer = tmoe.MoEMLP(d, f, e, k, cf, dtype=torch.float32)
    layer.load_state_dict({
        "router.weight": torch.tensor(np.asarray(params["router"]["kernel"]).T),
        "router.bias": torch.tensor(np.asarray(params["router"]["bias"])),
        "wi": torch.tensor(np.asarray(params["wi"])),
        "wo": torch.tensor(np.asarray(params["wo"]))})
    return layer


@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_mlp_output_aux_and_grads_match_jax(cf):
    d, f, e, k = 16, 32, 4, 2
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, d)).astype(np.float32)
    g = rng.normal(size=(2, 12, d)).astype(np.float32)
    layer, params = _flax_moe(d, f, e, k, cf, x)

    def objective(p, xx):
        out, state = layer.apply({"params": p}, xx, mutable=["intermediates"])
        aux = state["intermediates"]["moe_aux_loss"][0]
        return jnp.sum(out * g) + 0.5 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    port = _port_moe(d, f, e, k, cf, params)
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt)
    ((out * torch.from_numpy(g)).sum() + 0.5 * port.aux_loss).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    np.testing.assert_allclose(float(port.aux_loss.detach()), float(jaux),
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5)
    grads = {"router.weight": np.asarray(jgp["router"]["kernel"]).T,
             "router.bias": jgp["router"]["bias"], "wi": jgp["wi"],
             "wo": jgp["wo"]}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads[name]),
                                   atol=1e-5, err_msg=name)


def test_moe_aux_loss_is_the_mean_over_layers():
    model = T.TransformerLM(T.gpt_small_config(
        dtype=torch.float32, num_layers=4, d_model=32, num_heads=2, d_ff=64,
        vocab_size=64, max_len=16, moe_num_experts=4, moe_every=2))
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert [hasattr(b, "moe") for b in model.blocks] == [False, True, False,
                                                         True]
    model(torch.zeros((2, 8), dtype=torch.long))
    layers = [b.moe.aux_loss for b in model.blocks if hasattr(b, "moe")]
    torch.testing.assert_close(tmoe.moe_aux_loss(model),
                               (layers[0] + layers[1]) / 2)


# ---------------------------------------------------------------------------
# 3 AdamW steps: one process, gloo ranks, JAX on the global batch

SMALL = dict(num_layers=2, d_model=64, num_heads=2, d_ff=128,
             vocab_size=128, max_len=16, moe_num_experts=4, moe_every=2,
             moe_capacity_factor=0.5)
OPT = dict(schedule="cosine", warmup_steps=1, total_steps=5,
           weight_decay=0.1, grad_clip=1.0)
LR = 3e-3
AUX_WEIGHT = 0.01
ACCUM = 2
# name -> (mesh, zero, planted local routing)
CASES = {"dp2": ({"dp": 2}, False, False),
         "ep2": ({"ep": 2}, False, False),
         "tp2": ({"tp": 2}, False, False),
         "sp2": ({"sp": 2}, False, False),
         "fsdp2": ({"fsdp": 2}, False, False),
         "dp2_zero": ({"dp": 2}, True, False),
         "dp2_ep2": ({"dp": 2, "ep": 2}, False, False)}
FAULTS = {"dp2_local_routing": ({"dp": 2}, False, True)}


def batches():
    return [b["tokens"] for b, _ in
            zip(tdata.synthetic_tokens(8, 17, 128, seed=2), range(3))]


def _flax_init():
    cfg = J.gpt_small_config(dtype=jnp.float32, **SMALL)
    return jax.device_get(J.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32))["params"])


def jax_run(init):
    """The JAX MoE LM on one device over the global batches."""
    model = J.TransformerLM(J.gpt_small_config(dtype=jnp.float32, **SMALL))
    tx = joptim.lm_optimizer(LR, **OPT)
    state = j_create(jax.random.PRNGKey(0), model, tx,
                     jnp.zeros((2, 16), jnp.int32)).replace(params=init)
    step = j_make_step(j_loss_fn(model.apply, moe_aux_weight=AUX_WEIGHT),
                       donate=False, grad_accum=ACCUM)
    losses, aux = [], []
    for tokens in batches():
        state, metrics = step(state, {"tokens": jnp.asarray(tokens)})
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["moe_aux_loss"]))
    return losses, aux, params_from_flax(jax.device_get(state.params))


def port_run(init):
    model = T.TransformerLM(T.gpt_small_config(dtype=torch.float32, **SMALL))
    model.load_state_dict(init)
    state = create_train_state(model, toptim.lm_optimizer(LR, **OPT),
                               seed=None)
    step = make_train_step(lm_loss_fn(model, moe_aux_weight=AUX_WEIGHT),
                           grad_accum=ACCUM)
    losses, aux = [], []
    for tokens in batches():
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["moe_aux_loss"]))
    return losses, aux, model.state_dict()


def _job(name, axes, zero, local, init):
    return dict(name=name, mesh=axes, preset="gpt_small_config",
                config=dict(dtype=torch.float32, **SMALL), init=init,
                opt=dict(peak_lr=LR, **OPT), zero=zero, grad_accum=ACCUM,
                moe_aux_weight=AUX_WEIGHT, local_routing=local,
                batches=[torch.from_numpy(b) for b in batches()])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's results per case, one world per rank count started
    first; meanwhile the one-process port's and JAX's."""
    flax = _flax_init()
    init = params_from_flax(flax)
    jobs = {2: [], 4: []}
    for name, (axes, zero, local) in {**CASES, **FAULTS}.items():
        jobs[int(np.prod(list(axes.values())))].append(
            _job(name, axes, zero, local, init))
    worlds = {n: World(tmp_path_factory.mktemp(f"world{n}"), n,
                       dict(kind="shard", cases=cases))
              for n, cases in jobs.items()}
    out = {"port": port_run(init), "jax": jax_run(flax), "init": init,
           "ranks": {}}
    for n, world in worlds.items():
        results = world.results(timeout=300)
        for case in jobs[n]:
            out["ranks"][case["name"]] = [r[case["name"]] for r in results]
    return out


def _close(losses, aux, params, want, init):
    want_losses, want_aux, want_params = want
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(aux, want_aux, rtol=LOSS_RTOL, atol=0)
    moved = 0.0
    for key, value in want_params.items():
        if key.endswith("key.bias"):
            continue  # zero gradient in exact arithmetic (ROADMAP §C)
        torch.testing.assert_close(params[key], value, atol=PARAM_ATOL,
                                   rtol=0, msg=key)
        moved = max(moved, float((value - init[key]).abs().max()))
    assert moved > 10 * PARAM_ATOL


def test_one_process_matches_jax(runs):
    losses, aux, params = runs["port"]
    _close(losses, aux, params, runs["jax"], runs["init"])
    assert runs["jax"][1][0] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_match_jax_on_the_global_batch(runs, name):
    for rank in runs["ranks"][name]:
        _close(rank["losses"].numpy(), rank["aux"].numpy(), rank["params"],
               runs["jax"], runs["init"])


def test_local_routing_would_change_the_loss(runs):
    """Routing each dp rank's half of the batch alone changes the capacity
    and the drops: the losses leave the tolerance."""
    want = np.asarray(runs["jax"][0])
    for rank in runs["ranks"]["dp2_local_routing"]:
        gap = np.abs(rank["losses"].numpy() - want) / want
        assert gap.max() > 20 * LOSS_RTOL, gap


@pytest.mark.parametrize("name", ["ep2", "dp2_ep2"])
def test_each_ep_rank_holds_its_experts(runs, name):
    axes = CASES[name][0]
    mesh = build_mesh(axes, int(np.prod(list(axes.values()))))
    with torch.device("meta"):
        model = T.TransformerLM(T.gpt_small_config(**SMALL))
    layouts = param_layouts(model, mesh)
    for rank in runs["ranks"][name]:
        for n, lay in layouts.items():
            split = axes["ep"] if lay.ep_dim is not None else 1
            assert int(rank["local_params"][n]) == \
                model.get_parameter(n).numel() // split, n
            assert rank["held"][n] == lay.spec, n
    assert layouts["blocks.1.moe.wi"].spec == ("ep",)
    assert layouts["blocks.1.moe.router.weight"].spec == ()


# ---------------------------------------------------------------------------
# layouts and plans at GPT-small width with 8 experts

FULL_MOE = dict(moe_num_experts=8)
LAYOUT_MESHES = [{"ep": 2}, {"fsdp": 2}, {"dp": 2, "ep": 2},
                 {"fsdp": 2, "ep": 2}, {"tp": 2, "ep": 2}]
PLAN_MESHES = [{"dp": 2}, {"dp": 2, "ep": 2}, {"dp": 2, "tp": 2}]


def _full_models():
    with torch.device("meta"):
        port = T.TransformerLM(T.gpt_small_config(**FULL_MOE))
    shapes = jax.eval_shape(lambda: J.TransformerLM(J.gpt_small_config(
        **FULL_MOE)).init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32)))["params"]
    return port, shapes


def _mesh_pair(axes):
    n = int(np.prod(list(axes.values())))
    return build_mesh(axes, n), j_build_mesh(axes, devices=jax.devices()[:n])


@pytest.mark.parametrize("axes", LAYOUT_MESHES,
                         ids=[json.dumps(a) for a in LAYOUT_MESHES])
def test_moe_layout_is_the_jax_combined_spec(axes):
    port, shapes = _full_models()
    mesh, jmesh = _mesh_pair(axes)
    flat = {tuple(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    want = {path: tuple(j_combined("/".join(path), leaf.shape, jmesh))
            for path, leaf in flat.items()}
    layouts = param_layouts(port, mesh)
    assert {lay.path for lay in layouts.values()} == set(want)
    for lay in layouts.values():
        held = {axis: dim for axis, dim in (("tp", lay.tp_dim),
                                            ("ep", lay.ep_dim),
                                            ("fsdp", lay.fsdp_dim))
                if dim is not None}
        assert lay.spec == want[lay.path], lay.name
        assert lay.flax_spec(held, mesh) == want[lay.path], lay.name


@pytest.mark.parametrize("axes", PLAN_MESHES,
                         ids=[json.dumps(a) for a in PLAN_MESHES])
def test_moe_zero_plan_json_is_the_jax_plan(axes):
    port, shapes = _full_models()
    mesh, jmesh = _mesh_pair(axes)
    theirs = jzero.build_zero_plan(
        shapes, jmesh, base_specs=make_param_shardings(shapes, jmesh))
    assert tzero.plan_for_model(port, mesh).to_json() == theirs.to_json()


def test_moe_params_round_trip_through_flax():
    flax = _flax_init()
    back = params_to_flax(params_from_flax(flax))
    flat = jax.tree_util.tree_flatten_with_path(flax)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


# ---------------------------------------------------------------------------
# decoding an MoE model, and the workload


@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_moe_greedy_generation_matches_jax(arch):
    base = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32,
                d_ff=64, max_len=32, moe_num_experts=4,
                moe_capacity_factor=1.0)
    if arch == "llama":
        base.update(num_kv_heads=2, use_rope=True, norm="rmsnorm",
                    mlp="swiglu")
    jcfg = J.TransformerConfig(dtype=jnp.float32, **base)
    prompt = np.random.default_rng(4).integers(0, 64, (3, 6)).astype(
        np.int32)
    params = J.TransformerLM(jcfg).init(jax.random.PRNGKey(1),
                                        jnp.asarray(prompt))["params"]
    want = np.asarray(j_generate(jcfg, params, jnp.asarray(prompt), 10))
    model = T.TransformerLM(T.TransformerConfig(dtype=torch.float32, **base))
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    np.testing.assert_array_equal(generate(model, prompt, 10).numpy(), want)


TINY = ["--batch", "4", "--seq-len", "16", "--vocab", "64", "--layers", "2",
        "--d-model", "64", "--moe-experts", "2"]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUJOB_") and k != "TF_CONFIG"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TPUJOB_FORCE_PLATFORM="cpu", **extra)
    return env


def _losses(log):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step (\d+) loss (\S+)$", log, re.M)}


def test_workload_trains_moe_over_ep():
    """--moe-experts over {"ep": 2} as two processes: the one-process run's
    first loss (within 1e-2: bf16, and the experts' outputs summed over
    the ranks), `done` from rank 0 alone."""
    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.workloads.lm",
           "--steps", "2"] + TINY
    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(cmd, cwd=str(REPO), env=_env(dict(
        TPUJOB_NUM_PROCESSES="2", TPUJOB_PROCESS_ID=str(rank),
        TPUJOB_COORDINATOR_ADDRESS=address,
        TPUJOB_MESH_SHAPE=json.dumps({"ep": 2}))),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    single = subprocess.run(cmd, cwd=str(REPO), env=_env({}),
                            capture_output=True, text=True, timeout=240)
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert single.returncode == 0, single.stdout + single.stderr
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    want = _losses(single.stdout)
    got = _losses(logs[0])
    assert list(got) == list(want) == [0]
    assert abs(got[0] - want[0]) <= 1e-2
    assert logs[0].count("done") == 1 and "done" not in logs[1]


def test_remat_recomputes_the_moe_blocks_exactly():
    """Under remat the MoE block's forward runs again in the backward:
    the loss with its aux term, and every gradient, are the plain run's."""
    grads = {}
    for remat in (False, True):
        model = T.TransformerLM(T.gpt_small_config(
            dtype=torch.float32, remat=remat, **SMALL))
        model.reset_parameters(torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(batches()[0]).long()
        loss, aux = lm_loss_fn(model, moe_aux_weight=AUX_WEIGHT)(
            {"tokens": tokens})
        loss.backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=0, atol=0,
                                   msg=name)
    assert float(grads[False]["blocks.1.moe.router.weight"].abs().max()) > 0
