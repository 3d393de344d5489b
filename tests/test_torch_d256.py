"""The port at head dims 129-256: the flash-attention plumbing against the
Pallas kernels, and the llama-style LM at Gemma 2B's head size (256)
against the JAX package's.

The kernels' head-dim class 256 (`ops/attention.py:INSTANTIATED[...][256]`,
`csrc/flash_attention.cu`) runs on the card only; on CPU tensors each
wrapper computes its kernel's plain version, so these hold what surrounds
the kernels at head dims 160, 192, 250 (padded to 256 on the card) and 256
against `flash_attention_grads_interpret` and
`flash_attention_lse_grads_interpret` (the Pallas kernels in interpret
mode, which take any head dim).  tests/test_torch_kernels_cuda.py holds
the kernels themselves against the plain versions on the card.

Tolerances: those of tests/test_torch_attention.py (f32: 2e-5 on outputs
and lse, 1e-4 on gradients; fp16 5e-3), and for the model those of
tests/test_torch_transformer.py and tests/test_torch_train.py (logits
1e-5; losses, gradients and parameters 5e-5, PERF.md section 2's LM rule):
both sides sum the same products in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import transformer as J
from tf_operator_tpu.ops.attention import (
    flash_attention_grads_interpret,
    flash_attention_lse_grads_interpret,
)
from tf_operator_tpu.train import optim as joptim
from tf_operator_tpu.train.state import create_train_state as j_create
from tf_operator_tpu.train.step import lm_loss_fn as j_loss_fn
from tf_operator_tpu.train.step import make_train_step as j_make_step
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models.convert import (
    params_from_flax,
    params_to_flax,
)
from tf_operator_tpu_torch.ops import attention as A
from tf_operator_tpu_torch.train import optim as toptim
from tf_operator_tpu_torch.train.state import create_train_state
from tf_operator_tpu_torch.train.step import lm_loss_fn, make_train_step

from test_torch_attention import (
    ATOL_F16,
    ATOL_GRAD,
    ATOL_OUT,
    assert_matches,
    inputs,
    port_grads,
)

torch.set_num_threads(1)

# (t, d, h, kv_h, causal, window, sink, block_q, block_k): head dims across
# the class (250 is padded to 256 on the card; 160, 192 and 256 are not),
# GQA 8:1 (Gemma 2B's 8 query heads over one KV head) and window
# + sink at 256, ragged T and every block pair the class resolves to
CASES = {
    "d160_causal": (128, 160, 2, 2, True, None, 0, 64, 64),
    "d192_noncausal": (200, 192, 2, 2, False, None, 0, 64, 64),
    "d250_ragged": (300, 250, 2, 2, True, None, 0, 128, 128),
    "d256_causal": (256, 256, 2, 2, True, None, 0, 128, 128),
    "d256_gqa8": (256, 256, 8, 1, True, None, 0, 64, 64),
    "d256_window_sink": (256, 256, 2, 2, True, 64, 8, 64, 64),
    "d256_window_sink_gqa8_ragged": (200, 256, 8, 1, True, 40, 5, 128, 128),
    "d256_noncausal_gqa": (150, 256, 4, 2, False, None, 0, 64, 64),
}


@pytest.fixture(scope="module")
def interpret_results():
    """The Pallas kernels' (out, dq, dk, dv) per case, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            t, d, h, kv_h, causal, window, sink, bq, bk = CASES[name]
            q, k, v, g = inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=21)
            cache[name] = [np.asarray(x) for x in
                           flash_attention_grads_interpret(
                               q, k, v, g, causal, None, bq, bk,
                               window=window, sink=sink)]
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_matches_pallas_interpret(name, interpret_results):
    """The public entry on CPU tensors (plain version under autograd)."""
    t, d, h, kv_h, causal, window, sink, _, _ = CASES[name]
    q, k, v, g = inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=21)
    got = port_grads(q, k, v, g, lambda q, k, v: A.flash_attention(
        q, k, v, causal, window=window, sink=sink))
    assert_matches(got, interpret_results(name))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_autograd_function_matches_pallas_interpret(
        name, interpret_results):
    """FlashAttentionFn, whose wrappers compute the forward / dq / dk-dv
    kernels' plain versions on CPU tensors, at the class's head dims."""
    t, d, h, kv_h, causal, window, sink, bq, bk = CASES[name]
    q, k, v, g = inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=21)
    before = A.launches()
    got = port_grads(q, k, v, g, lambda q, k, v: A.FlashAttentionFn.apply(
        q, k, v, causal, d ** -0.5, bq, bk, A.check_window(causal, window),
        sink))
    assert_matches(got, interpret_results(name))
    assert A.launches() == before  # the plain path launches no kernel


@pytest.mark.parametrize("entry", ["public", "autograd_function"])
@pytest.mark.parametrize("t,d,h,kv_h,causal", [
    (128, 256, 2, 2, True), (130, 200, 8, 1, False)],
    ids=["d256_causal", "d200_gqa8_noncausal"])
def test_flash_attention_lse_matches_pallas_interpret(entry, t, d, h, kv_h,
                                                      causal):
    """(o, lse) with cotangents on both outputs: out and lse within 2e-5,
    gradients 1e-4 of the Pallas kernels in interpret mode; the
    autograd function's backward hands the kernels delta' = rowsum(dO *
    O) - dlse."""
    q, k, v, g = inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=23)
    g_lse = np.random.RandomState(24).randn(1, h, t).astype(np.float32)
    want = flash_attention_lse_grads_interpret(q, k, v, g, g_lse, causal,
                                               None, 64, 64)
    if entry == "public":
        def fn(q, k, v):
            return A.flash_attention_lse(q, k, v, causal)
    else:
        def fn(q, k, v):
            return A.FlashAttentionLseFn.apply(q, k, v, causal, d ** -0.5,
                                               64, 64)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = fn(qt, kt, vt)
    torch.autograd.backward((out, lse), (torch.tensor(g), torch.tensor(g_lse)))
    got = [x.detach().numpy() for x in (out, lse, qt.grad, kt.grad, vt.grad)]
    for label, a, b, tol in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                                (ATOL_OUT,) * 2 + (ATOL_GRAD,) * 3):
        assert a.shape == np.asarray(b).shape, label
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, err_msg=label)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32],
                         ids=["fp16", "f32"])
def test_fp16_and_f32_at_head_dim_256_match_pallas_interpret(dtype):
    """fp16 and f32 inputs at head_dim 256, causal, GQA 8:1, T 128: the
    dtypes kept through FlashAttentionFn's plumbing."""
    np_dtype = {torch.float16: np.float16, torch.float32: np.float32}[dtype]
    q, k, v, g = (x.astype(np_dtype) for x in
                  inputs(128, d=256, b=1, h=8, kv_h=1, seed=25))
    want = flash_attention_grads_interpret(
        *(jnp.asarray(x) for x in (q, k, v, g)), True, None, 64, 64)
    got = port_grads(q, k, v, g, lambda q, k, v: A.FlashAttentionFn.apply(
        q, k, v, True, 256 ** -0.5, 64, 64, None, 0))
    tol = ATOL_F16 if dtype == torch.float16 else ATOL_GRAD
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == np_dtype and a.shape == b.shape, name
        np.testing.assert_allclose(a.astype(np.float32),
                                   np.asarray(b, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)


@pytest.mark.parametrize("d,want", [
    (1, 64), (64, 64), (65, 128), (128, 128), (129, 256), (136, 256),
    (200, 256), (256, 256)])
def test_head_class_holds_every_head_dim_up_to_256(d, want):
    assert A.head_class(d) == want


@pytest.mark.parametrize("d", [0])
def test_head_class_below_1_raises(d):
    with pytest.raises(ValueError, match=r"head_dim >= 1"):
        A.head_class(d)


def test_resolve_tiles_maps_every_block_pair_onto_the_256_class():
    """Every (block_q, block_k) the env takes resolves at head dims
    129-256 to an instantiation of the 256 class, in each dtype; (128,
    128) keeps 128-row forward tiles and dq's and dk/dv's one tile (since
    the thirteenth slice dq's two warpgroups of 64 rows over a 64-key step
    and dk/dv's 64-query step)."""
    built = A.instantiations()
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for d in (129, 136, 160, 250, 256):
            for bq in range(8, 1025, 8):
                for bk in range(64, 1025, 64):
                    tiles = A.resolve_tiles(bq, bk, d, dtype)
                    for kernel in ("fwd", "dq", "dkv"):
                        assert (kernel, name, 256,
                                *getattr(tiles, kernel)) in built
    assert A.resolve_tiles(128, 128, 256, torch.bfloat16) == A.Tiles(
        fwd=(128, 64), dq=(128, 64), dkv=(64, 64))
    assert A.resolve_tiles(32, 64, 200, torch.float16) == A.Tiles(
        fwd=(64, 64), dq=(128, 64), dkv=(64, 64))


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 256), (torch.float16, 160), (torch.float32, 250),
    (torch.bfloat16, 129)])
def test_check_cuda_takes_head_dims_up_to_256(dtype, d):
    """`_check_cuda` (shapes, dtypes and layouts only, so on CPU tensors)
    takes the class's head dims at GQA 8:1."""
    q = torch.empty(2, 8, 4, d, dtype=dtype)
    kv = torch.empty(2, 1, 4, d, dtype=dtype)
    rows = torch.empty(2, 8, 4)
    A._check_cuda(q, kv, kv, q, rows, rows)


def test_padded_head_dim_reaches_the_256_class():
    """A head dim that is not a multiple of 8 is zero-padded to the next
    one (250 -> 256, 129 -> 136) and the outputs sliced back."""
    for d, stored in ((250, 256), (129, 136), (256, 256)):
        (x,) = A._padded(torch.ones(1, 1, 2, d))
        assert x.shape[-1] == stored and A.head_class(stored) == 256
        assert float(x[..., d:].abs().sum()) == 0.0
        assert A._unpadded(x, d).shape[-1] == d


# the llama-style LM at Gemma 2B's attention shape (head_dim 256, one KV
# head), cut to 2 layers, d_model 512 (2 heads of 256), vocab 256, T 64;
# d_ff = d_model * 8 // 3 as the LM workload sizes its SwiGLU
GEMMA_ATTN = dict(num_layers=2, d_model=512, num_heads=2, num_kv_heads=1,
                  d_ff=512 * 8 // 3, vocab_size=256, max_len=64)
LOGITS_ATOL = 1e-5
LM_ATOL = 5e-5
OPT = dict(schedule="cosine", warmup_steps=2, total_steps=5,
           weight_decay=0.1, grad_clip=1.0)


def _lm_tokens(b=2, t=64, seed=0):
    return np.random.RandomState(seed).randint(
        0, GEMMA_ATTN["vocab_size"], (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def gemma_attention_lms():
    jcfg = J.llama_style_config(dtype=jnp.float32, **GEMMA_ATTN)
    tcfg = T.llama_style_config(dtype=torch.float32, **GEMMA_ATTN)
    assert tcfg.d_model // tcfg.num_heads == 256
    params = jax.device_get(J.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(_lm_tokens()))["params"])
    return jcfg, tcfg, params


def _port_model(tcfg, params):
    model = T.TransformerLM(tcfg)
    model.load_state_dict(params_from_flax(params))
    return model


def test_lm_at_head_dim_256_logits_match_flax(gemma_attention_lms):
    jcfg, tcfg, params = gemma_attention_lms
    model = _port_model(tcfg, params)
    tok = _lm_tokens()
    want = J.TransformerLM(jcfg).apply({"params": params}, jnp.asarray(tok))
    with torch.no_grad():
        got = model(torch.from_numpy(tok))
    assert got.shape == want.shape == (2, 64, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL)


def test_lm_at_head_dim_256_loss_and_gradients_match_jax(
        gemma_attention_lms):
    """The LM workload's loss (next-token cross-entropy) and its gradient
    with respect to every parameter, on the same tokens."""
    jcfg, tcfg, params = gemma_attention_lms
    model = _port_model(tcfg, params)
    tok = _lm_tokens(seed=1)
    jloss = j_loss_fn(J.TransformerLM(jcfg).apply)
    (want_loss, _), want_grads = jax.value_and_grad(jloss, has_aux=True)(
        params, {"tokens": jnp.asarray(tok)})
    loss, _ = lm_loss_fn(model)({"tokens": torch.from_numpy(tok)})
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < LM_ATOL
    grads = params_to_flax({name: p.grad for name, p in
                            model.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(want_grads)
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert len(got) == len(leaves)
    for path, want in leaves:
        np.testing.assert_allclose(got[path], np.asarray(want), atol=LM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_lm_at_head_dim_256_train_steps_match_jax(gemma_attention_lms):
    """Four steps of the LM's train step and AdamW schedule (clip 1.0,
    decay 0.1, warmup + cosine) from the same params: losses and the
    parameters after them."""
    jcfg, tcfg, params = gemma_attention_lms
    jmodel = J.TransformerLM(jcfg)
    jstate = j_create(jax.random.PRNGKey(0), jmodel,
                      joptim.lm_optimizer(3e-3, **OPT),
                      jnp.zeros((2, 64), jnp.int32))
    jstate = jstate.replace(params=params)
    model = _port_model(tcfg, params)
    state = create_train_state(model, toptim.lm_optimizer(3e-3, **OPT),
                               seed=None)
    jstep = j_make_step(j_loss_fn(jmodel.apply), donate=False)
    step = make_train_step(lm_loss_fn(model))
    for seed in (2, 3, 4, 5):
        tok = _lm_tokens(seed=seed)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
        state, m = step(state, {"tokens": torch.from_numpy(tok)})
        assert abs(float(m["loss"]) - float(jm["loss"])) < LM_ATOL
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_flax(model.state_dict())))
    moved = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jstate.params)):
        np.testing.assert_allclose(got[path], np.asarray(want), atol=LM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    for (path, init), (_, after) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(
                jax.device_get(jstate.params))):
        moved = max(moved, float(np.abs(np.asarray(after) - init).max()))
    assert moved > 100 * LM_ATOL  # the steps really moved the params
