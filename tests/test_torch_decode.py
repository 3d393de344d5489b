"""The port's KV-cache decoding against the JAX package's.

The JAX `TestGenerate` model (2 layers, d_model 32, 4 heads, vocab 64,
max_len 32, f32), gpt and llama (GQA 4/2, RoPE), with the same flax params
(`params_from_flax`): greedy tokens are JAX `generate`'s token for token
with the full cache, the rolling window, window with sinks and the int8
cache (prompts longer than the window, so the chunked prefill drops
tokens, and enough new tokens for the rolling region to wrap); the cache's
leaves have JAX's shapes and dtypes; a chunked prefill from a partially
filled JAX cache (`cache_from_flax`) gives JAX's logits within 1e-5 and
leaves the cache JAX leaves.  `top_k=1` is greedy, sampling is
deterministic under one generator and stays in the top-k support, and
generation under {"tp": 2} over gloo ranks equals the unsharded port and
JAX.  Last, the workload's `--sample-tokens`.
"""
import dataclasses
import json
import os
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
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models.convert import (cache_from_flax,
                                                  params_from_flax)
from tf_operator_tpu_torch.models.generate import generate
from torch_dist_worker import World

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BASE = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_len=32)
LLAMA = dict(num_kv_heads=2, use_rope=True, norm="rmsnorm", mlp="swiglu")
CACHES = {"full": {}, "window": dict(attn_window=6),
          "window_sink": dict(attn_window=6, attn_sink=3),
          "int8": dict(kv_cache_dtype="int8"),
          "int8_window_sink": dict(kv_cache_dtype="int8", attn_window=6,
                                   attn_sink=2)}


def _configs(arch, **extra):
    kw = dict(BASE, **(LLAMA if arch == "llama" else {}), **extra)
    return (J.TransformerConfig(dtype=jnp.float32, **kw),
            T.TransformerConfig(dtype=torch.float32, **kw))


def _pair(arch, seed=1, **extra):
    """(JAX config, flax params, port model) with the same weights."""
    jcfg, tcfg = _configs(arch, **extra)
    params = jax.device_get(J.TransformerLM(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((2, 4), jnp.int32))["params"])
    model = T.TransformerLM(tcfg)
    model.load_state_dict(params_from_flax(params))
    return jcfg, params, model


def _prompt(batch, length, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (batch, length)) \
        .astype(np.int32)


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_greedy_tokens_match_jax(arch, cache):
    jcfg, params, model = _pair(arch, **CACHES[cache])
    prompt = _prompt(2, 9)
    want = np.asarray(j_generate(jcfg, params, jnp.asarray(prompt), 14))
    got = generate(model, prompt, 14)
    assert got.shape == (2, 23) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_cache(jcfg, params=None, tokens=None):
    """The JAX decode cache: fresh (zeros), or after `tokens`."""
    model = J.TransformerLM(dataclasses.replace(jcfg, decode=True))
    cache = model.init(jax.random.PRNGKey(0),
                       jnp.zeros((2, 1), jnp.int32))["cache"]
    cache = jax.tree_util.tree_map(jnp.zeros_like, cache)
    if tokens is None:
        return model, cache
    logits, mut = model.apply({"params": params, "cache": cache},
                              jnp.asarray(tokens), mutable=["cache"])
    return model, mut["cache"], logits


def _leaves(cache):
    """{flax path: leaf} of a port DecodeCache, under the flax names."""
    out = {("wpe_index",): cache.wpe_index}
    for i, layer in enumerate(cache.layers):
        for field in dataclasses.fields(layer):
            value = getattr(layer, field.name)
            if value is not None:
                out[(f"block_{i}", "attn", field.name)] = value
    return out


def _flat(tree):
    return {tuple(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_cache_leaves_have_the_jax_shapes_and_dtypes(arch, cache):
    jcfg, _, model = _pair(arch, **CACHES[cache])
    _, want = _jax_cache(jcfg)
    got = _leaves(model.init_cache(2))
    want = _flat(want)
    if "wpe_index" not in {p[0] for p in want}:
        del got[("wpe_index",)]  # rotary models keep no learned positions
    assert set(got) == set(want)
    for path, leaf in want.items():
        if leaf.ndim == 0:
            assert got[path] == 0, path
            continue
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
    window = CACHES[cache].get("attn_window")
    slots = got[("block_0", "attn", "cached_key")].shape[2]
    assert slots == (window + CACHES[cache].get("attn_sink", 0)
                     if window else jcfg.max_len)


@pytest.mark.parametrize("cache", ["full", "window", "window_sink",
                                   "int8_window_sink"])
@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_chunked_prefill_continues_a_jax_cache(arch, cache):
    """Chunk one (5 tokens) through JAX, its cache carried over by
    `cache_from_flax`, chunk two (4 tokens) through the port: JAX's logits
    for chunk two within 1e-5, and JAX's cache after it."""
    jcfg, params, model = _pair(arch, **CACHES[cache])
    tokens = _prompt(2, 9, seed=8)
    jmodel, first, _ = _jax_cache(jcfg, params, tokens[:, :5])
    want, after = jmodel.apply({"params": params, "cache": first},
                               jnp.asarray(tokens[:, 5:]), mutable=["cache"])
    cache = cache_from_flax(jax.device_get(first))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens[:, 5:]).long(), cache=cache)
    assert got.shape == (2, 1, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want_leaves = _flat(jax.device_get(after["cache"]))
    got_leaves = _leaves(cache)
    for path, leaf in want_leaves.items():
        value = got_leaves[path]
        if leaf.ndim == 0:
            assert value == int(leaf), path
        elif leaf.dtype == np.int8 or leaf.dtype == np.int32:
            np.testing.assert_array_equal(value.numpy(), leaf, err_msg=path)
        else:
            np.testing.assert_allclose(value.numpy(), leaf, atol=1e-5,
                                       err_msg=str(path))


@pytest.mark.parametrize("kwargs,match", [
    (dict(max_new_tokens=0), "max_new_tokens must be >= 1"),
    (dict(temperature=-1.0), "temperature must be >= 0"),
    (dict(top_k=65), "top_k must be in \\[0, vocab_size 64\\]"),
    (dict(top_k=-1), "top_k must be in"),
    (dict(max_new_tokens=24), "exceeds max_len 32"),
    (dict(temperature=1.0), "needs an rng"),
])
def test_validation_errors_are_the_jax_ones(kwargs, match):
    jcfg, params, model = _pair("gpt")
    prompt = np.zeros((1, 9), np.int32)
    args = dict(max_new_tokens=2)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        generate(model, prompt, **args)
    jargs = {("rng" if k == "generator" else k): v for k, v in args.items()}
    with pytest.raises(ValueError, match=match):
        j_generate(jcfg, params, jnp.asarray(prompt), **jargs)


def test_a_decode_config_runs_with_a_cache():
    _, tcfg = _configs("gpt", decode=True)
    model = T.TransformerLM(tcfg)
    with pytest.raises(ValueError, match="init_cache"):
        model(torch.zeros((1, 4), dtype=torch.long))
    cache = model.init_cache(1)
    assert model(torch.zeros((1, 4), dtype=torch.long),
                 cache=cache).shape == (1, 1, 64)
    assert cache.wpe_index == 4 and cache.layers[0].cache_index == 4


def test_top_k_one_equals_greedy():
    _, _, model = _pair("gpt")
    prompt = _prompt(2, 4)
    greedy = generate(model, prompt, 5)
    topk1 = generate(model, prompt, 5, temperature=2.0, top_k=1,
                     generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(topk1, greedy, rtol=0, atol=0)


def test_sampling_is_deterministic_and_stays_in_the_top_k():
    _, _, model = _pair("llama")
    prompt = _prompt(3, 4)

    def sample(seed):
        return generate(model, prompt, 12, temperature=0.8, top_k=5,
                        generator=torch.Generator().manual_seed(seed))

    a, b = sample(7), sample(7)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (3, 16)
    assert not torch.equal(a, sample(8))
    # each drawn token among its step's 5 largest logits (the full forward
    # over the sequence gives every step's logits)
    with torch.no_grad():
        logits = model(a[:, :-1])[:, 3:]
    kth = torch.topk(logits, 5, dim=-1).values[..., -1]
    drawn = logits.gather(-1, a[:, 4:, None])[..., 0]
    assert bool((drawn >= kth - 1e-5).all())


# ---------------------------------------------------------------------------
# generation under tp over gloo ranks

TP_CASES = {"gpt_full": ("gpt", "full"), "llama_full": ("llama", "full"),
            "gpt_int8_window_sink": ("gpt", "int8_window_sink"),
            "llama_window_sink": ("llama", "window_sink")}
SAMPLED = dict(temperature=1.0, top_k=8, seed=5)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    prompt = _prompt(2, 7, seed=3)
    cases, want = [], {}
    for name, (arch, cache) in TP_CASES.items():
        jcfg, params, model = _pair(arch, **CACHES[cache])
        preset = "llama_style_config" if arch == "llama" else \
            "gpt_small_config"
        config = dict(dtype=torch.float32, **BASE, **CACHES[cache],
                      **(dict(num_kv_heads=2) if arch == "llama" else {}))
        job = dict(preset=preset, config=config, mesh={"tp": 2},
                   init=model.state_dict(), prompt=torch.from_numpy(prompt),
                   new_tokens=12)
        cases.append(dict(job, name=name))
        cases.append(dict(job, name=name + "_sampled", **SAMPLED))
        want[name] = (
            generate(model, prompt, 12).numpy(),
            np.asarray(j_generate(jcfg, params, jnp.asarray(prompt), 12)),
            generate(model, prompt, 12, temperature=SAMPLED["temperature"],
                     top_k=SAMPLED["top_k"],
                     generator=torch.Generator().manual_seed(
                         SAMPLED["seed"])).numpy(),
            model.init_cache(2).layers[0].cached_key.shape)
    world = World(tmp_path_factory.mktemp("tp2"), 2,
                  dict(kind="decode", cases=cases))
    return world.results(timeout=300), want


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp2_generation_matches_unsharded_and_jax(tp_runs, name):
    ranks, want = tp_runs
    port, jax_tokens, sampled, shape = want[name]
    np.testing.assert_array_equal(port, jax_tokens)
    for rank in ranks:
        np.testing.assert_array_equal(rank[name]["tokens"].numpy(), port)
        # every rank draws the same sample, the unsharded model's
        np.testing.assert_array_equal(
            rank[name + "_sampled"]["tokens"].numpy(), sampled)
        # each rank's cache holds half the KV heads
        got = tuple(rank[name]["cache_shape"].tolist())
        assert got == (shape[0], shape[1] // 2) + tuple(shape[2:])


# ---------------------------------------------------------------------------
# the workload

TINY = ["--steps", "2", "--batch", "4", "--seq-len", "16", "--vocab", "64",
        "--layers", "1", "--d-model", "64"]


def _run(args, extra_env=None, processes=1):
    import socket

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUJOB_") and k != "TF_CONFIG"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TPUJOB_FORCE_PLATFORM="cpu", **(extra_env or {}))
    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.workloads.lm"] + args
    if processes == 1:
        return [subprocess.run(cmd, cwd=str(REPO), env=env, text=True,
                               capture_output=True, timeout=240)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen(cmd, cwd=str(REPO), env=dict(
        env, TPUJOB_NUM_PROCESSES=str(processes),
        TPUJOB_PROCESS_ID=str(rank), TPUJOB_COORDINATOR_ADDRESS=address),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(processes)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [subprocess.CompletedProcess(cmd, p.returncode, out, err)
            for p, (out, err) in zip(procs, outs)]


def _sample_line(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("sample: ")]
    assert len(lines) == 1, out
    return json.loads(lines[0][len("sample: "):])


@pytest.mark.parametrize("extra", [[], ["--kv-cache-dtype", "int8",
                                        "--arch", "llama", "--attn-window",
                                        "4", "--attn-sink", "2"]],
                         ids=["model", "int8_llama_window_sink"])
def test_workload_prints_a_sample_of_prompt_plus_new_tokens(extra):
    """One CPU process: the 8-token prompt (the first tokens of a fresh
    `synthetic_tokens(1, 9, vocab)` stream) and 6 greedy tokens, before
    `done`."""
    from tf_operator_tpu_torch.train.data import synthetic_tokens

    (run,) = _run(TINY + ["--sample-tokens", "6"] + extra)
    assert run.returncode == 0, run.stdout + run.stderr
    tokens = _sample_line(run.stdout)
    prompt = next(synthetic_tokens(1, 9, 64))["tokens"][0, :8]
    assert len(tokens) == 14 and tokens[:8] == prompt.tolist()
    assert all(0 <= t < 64 for t in tokens)
    assert run.stdout.index("sample: ") < run.stdout.index("done")


def test_workload_skips_sampling_over_processes():
    runs = _run(TINY + ["--sample-tokens", "4"],
                {"TPUJOB_MESH_SHAPE": json.dumps({"dp": 2})}, processes=2)
    assert all(r.returncode == 0 for r in runs), runs[0].stdout
    assert "sampling skipped on multi-host runs" in runs[0].stdout
    assert "sample: " not in runs[0].stdout + runs[1].stdout
