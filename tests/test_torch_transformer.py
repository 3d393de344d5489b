"""Parity of the PyTorch port's Transformer LM with the JAX package's.

flax params are initialised from a seed, carried over with
`params_from_flax`, and both models see the same numpy tokens.  In f32 the
logits agree within 1e-5 (same products, different summation order; the
largest logit is ~1).  The config's validation raises the same errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import transformer as J
from tf_operator_tpu.train.step import chunked_softmax_xent as jax_chunked
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models.convert import (
    params_from_flax,
    params_to_flax,
)
from tf_operator_tpu_torch.train.step import (
    chunked_softmax_xent,
    softmax_cross_entropy,
)

torch.set_num_threads(1)

SMALL = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=128,
             max_len=64)
ARCHS = {
    "gpt": (J.gpt_small_config, T.gpt_small_config, dict(d_ff=128)),
    "llama": (J.llama_style_config, T.llama_style_config,
              dict(num_kv_heads=2, d_ff=96)),
    "llama_ntk_window": (J.llama_style_config, T.llama_style_config,
                         dict(num_kv_heads=2, d_ff=96, rope_scaling="ntk",
                              rope_factor=2.0, attn_window=16,
                              attn_sink=4)),
}


def tokens(b=2, t=48, vocab=128, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(
        np.int32)


def build(arch, **extra):
    jax_cfg_fn, torch_cfg_fn, kw = ARCHS[arch]
    kw = {**SMALL, **kw, **extra}
    jcfg = jax_cfg_fn(dtype=jnp.float32, **kw)
    tcfg = torch_cfg_fn(dtype=torch.float32, **kw)
    params = jax.device_get(J.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens()))["params"])
    model = T.TransformerLM(tcfg)
    model.load_state_dict(params_from_flax(params))
    return jcfg, params, model


@pytest.mark.parametrize("arch", list(ARCHS))
def test_logits_match_flax(arch):
    jcfg, params, model = build(arch)
    tok = tokens()
    want = J.TransformerLM(jcfg).apply({"params": params}, jnp.asarray(tok))
    with torch.no_grad():
        got = model(torch.from_numpy(tok))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_converter_round_trips(arch):
    _, params, model = build(arch)
    back = params_to_flax(model.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf))


@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_chunked_loss_equals_full_and_matches_jax(arch):
    """return_hidden + chunked_softmax_xent equals the full-logits loss
    (same readout formulation; 2e-5 as the JAX package pins it) and the
    JAX chunked loss."""
    jcfg, params, model = build(arch)
    tok = tokens(t=49)
    x, y = torch.from_numpy(tok[:, :-1]), torch.from_numpy(tok[:, 1:])
    with torch.no_grad():
        full = softmax_cross_entropy(model(x), y)
        hidden = model(x, return_hidden=True)
        chunked = chunked_softmax_xent(hidden, model.wte.weight, y, 20)
    assert abs(float(full) - float(chunked)) < 2e-5
    want = jax_chunked(
        J.TransformerLM(jcfg).apply({"params": params}, jnp.asarray(tok[:, :-1]),
                                    return_hidden=True),
        params["wte"]["embedding"], jnp.asarray(tok[:, 1:]), 20)
    assert abs(float(chunked) - float(want)) < 2e-5


def test_chunked_loss_gradients_equal_full():
    _, _, model = build("gpt")
    tok = tokens(t=33)
    x, y = torch.from_numpy(tok[:, :-1]), torch.from_numpy(tok[:, 1:])
    softmax_cross_entropy(model(x), y).backward()
    full = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    chunked_softmax_xent(model(x, return_hidden=True), model.wte.weight, y,
                         7).backward()
    for a, p in zip(full, model.parameters()):
        torch.testing.assert_close(p.grad, a, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="chunk must be positive"):
        chunked_softmax_xent(model(x, return_hidden=True), model.wte.weight,
                             y, 0)


def test_remat_and_plain_attention_paths_match():
    _, _, model = build("llama")
    tok = torch.from_numpy(tokens())
    with torch.no_grad():
        ref = model(tok)
    for flag in (dict(remat=True), dict(use_flash=False)):
        cfg = T.llama_style_config(dtype=torch.float32, num_kv_heads=2,
                                   d_ff=96, **SMALL, **flag)
        other = T.TransformerLM(cfg)
        other.load_state_dict(model.state_dict())
        out = other(tok)
        torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
        out.sum().backward()  # remat's recompute runs under backward


@pytest.mark.parametrize("scaling,factor", [("none", 1.0), ("linear", 4.0),
                                            ("ntk", 4.0)])
def test_rope_matches_jax(scaling, factor):
    x = np.random.RandomState(1).randn(2, 3, 40, 16).astype(np.float32)
    want = J.rope(jnp.asarray(x), theta=10000.0, scaling=scaling,
                  factor=factor)
    got = T.rope(torch.from_numpy(x), theta=10000.0, scaling=scaling,
                 factor=factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bf16_compute_keeps_f32_params():
    cfg = T.gpt_small_config(**SMALL, d_ff=128)
    model = T.TransformerLM(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    logits = model(torch.from_numpy(tokens()))
    assert logits.dtype == torch.float32
    assert model(torch.from_numpy(tokens()),
                 return_hidden=True).dtype == torch.bfloat16


@pytest.mark.parametrize("kwargs,match", [
    (dict(norm="batchnorm"), "norm must be"),
    (dict(mlp="relu"), "mlp must be"),
    (dict(seq_parallel="tree"), "seq_parallel must be"),
    (dict(use_rope=True, d_model=60, num_heads=4), "even head_dim"),
    (dict(kv_cache_dtype="fp8"), "kv_cache_dtype"),
    (dict(rope_scaling="yarn"), "rope_scaling must be"),
    (dict(rope_scaling="linear"), "requires use_rope"),
    (dict(use_rope=True, rope_scaling="ntk", rope_factor=0.5), "rope_factor"),
    (dict(num_kv_heads=5), "num_kv_heads"),
    (dict(attn_window=-1), "attn_window must be"),
    (dict(attn_window=8, causal=False), "requires causal"),
    (dict(attn_sink=-1), "attn_sink must be"),
    (dict(attn_sink=2), "requires attn_window"),
    (dict(attn_window=8, attn_sink=64, max_len=64), "must be < max_len"),
])
def test_config_validation_matches_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        J.TransformerConfig(**kwargs)
    with pytest.raises(ValueError, match=match):
        T.TransformerConfig(**kwargs)


@pytest.mark.parametrize("axes,kwargs,match", [
    ({"sp": 8}, dict(seq_parallel="ulysses", num_heads=12, d_model=96),
     "needs num_heads \\(12\\) divisible by the 'sp' axis size \\(8\\)"),
    ({"dp": 2, "sp": 4}, dict(attn_window=8),
     "attn_window does not compose with sequence parallelism"),
    ({"dp": 8}, dict(seq_parallel="ulysses", num_heads=12, d_model=96), None),
    ({"dp": 4, "sp": 2}, dict(seq_parallel="ulysses"), None),
])
def test_mesh_config_validation_matches_jax(axes, kwargs, match):
    """A config with a mesh (the JAX mesh over 8 virtual devices, the
    port's over 8 ranks) is checked as the JAX package checks it: Ulysses
    needs the heads to split over sp, and a window does not compose with
    sp > 1."""
    from tf_operator_tpu.parallel.mesh import build_mesh as j_build_mesh
    from tf_operator_tpu_torch.parallel.mesh import build_mesh

    pairs = ((J.TransformerConfig, j_build_mesh(axes)),
             (T.TransformerConfig, build_mesh(axes, 8)))
    for config, mesh in pairs:
        if match is None:
            assert config(mesh=mesh, **kwargs).mesh is mesh
        else:
            with pytest.raises(ValueError, match=match):
                config(mesh=mesh, **kwargs)
