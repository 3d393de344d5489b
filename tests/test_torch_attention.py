"""Parity of the PyTorch port's attention (tf_operator_tpu_torch.ops.attention)
with the JAX package's.

The same numpy inputs go through the JAX Pallas kernels in interpret mode
(`flash_attention_grads_interpret`) or `xla_attention_lse`, and through the
port: its public `flash_attention` (on the CPU: the plain version under
autograd) and its `FlashAttentionFn` (on the CPU its kernel wrappers
compute each kernel's plain version, so this checks the forward/backward
plumbing the CUDA kernels sit in: lse residual, delta, GQA folding).  The
hand-written kernels themselves need the card:
tests/test_torch_kernels_cuda.py compares them with the plain versions
there.

`flash_attention_lse` (the (o, lse) entry, with cotangents on both outputs)
is held against `flash_attention_lse_grads_interpret` the same way.

Tolerances: f32 everywhere; 2e-5 on outputs and lse, 1e-4 on gradients —
the JAX package's own interpret-vs-XLA tolerances (tests/test_ops.py), since
both sides sum the same products in a different order.  bf16 inputs: 0.06,
the JAX package's bf16 tolerance against an f32 reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops import autotune as jax_autotune
from tf_operator_tpu.ops.attention import (
    flash_attention_grads_interpret,
    flash_attention_lse_grads_interpret,
    xla_attention_lse,
)
from tf_operator_tpu_torch.ops import attention as A

torch.set_num_threads(1)

ATOL_OUT = 2e-5
ATOL_GRAD = 1e-4


def inputs(t, d=16, b=2, h=2, kv_h=None, seed=0):
    rng = np.random.RandomState(seed)
    kv_h = kv_h or h
    q = rng.randn(b, h, t, d).astype(np.float32)
    k = rng.randn(b, kv_h, t, d).astype(np.float32)
    v = rng.randn(b, kv_h, t, d).astype(np.float32)
    g = rng.randn(b, h, t, d).astype(np.float32)
    return q, k, v, g


def port_grads(q, k, v, g, fn):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(qt, kt, vt)
    out.backward(torch.tensor(g))
    return [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)]


def assert_matches(got, want):
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (ATOL_OUT, ATOL_GRAD, ATOL_GRAD, ATOL_GRAD)):
        assert a.shape == np.asarray(b).shape, name
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, err_msg=name)


# (t, d, h, kv_h, causal, window, sink, block_q, block_k) — cases of
# tests/test_ops.py: causal and not, padded T, GQA, window, window + sink,
# window wider than T
CASES = {
    "causal": (128, 16, 2, 2, True, None, 0, 64, 64),
    "noncausal": (128, 16, 2, 2, False, None, 0, 64, 64),
    "padded_causal": (100, 16, 2, 2, True, None, 0, 64, 64),
    "padded_noncausal": (65, 16, 2, 2, False, None, 0, 64, 64),
    "gqa": (100, 16, 4, 2, True, None, 0, 64, 64),
    "gqa_d128": (64, 128, 4, 2, True, None, 0, 64, 64),
    "window": (256, 16, 2, 2, True, 64, 0, 64, 64),
    "window_ragged": (100, 16, 2, 2, True, 30, 0, 64, 64),
    "window_gqa": (128, 16, 4, 2, True, 40, 0, 64, 64),
    "window_sink": (256, 16, 2, 2, True, 32, 8, 64, 64),
    "window_sink_ragged": (100, 16, 2, 2, True, 30, 5, 64, 64),
    "window_wider_than_t": (128, 16, 2, 2, True, 500, 0, 64, 64),
    # ViT-B/16's attention at its ragged length and width (T 197, 64 wide),
    # non-causal: on the card the encoders' kernels' route
    "vit_ragged_noncausal": (197, 64, 2, 2, False, None, 0, 128, 128),
}


@pytest.fixture(scope="module")
def interpret_results():
    """The Pallas kernels' (out, dq, dk, dv) per case, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            t, d, h, kv_h, causal, window, sink, bq, bk = CASES[name]
            q, k, v, g = inputs(t, d=d, h=h, kv_h=kv_h)
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
    q, k, v, g = inputs(t, d=d, h=h, kv_h=kv_h)
    got = port_grads(q, k, v, g, lambda q, k, v: A.flash_attention(
        q, k, v, causal, window=window, sink=sink))
    assert_matches(got, interpret_results(name))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_autograd_function_matches_pallas_interpret(
        name, interpret_results):
    """FlashAttentionFn, whose wrappers compute the forward / dq / dk-dv
    kernels' plain versions on CPU tensors: the custom backward (lse
    residual, delta = rowsum(dO * O), GQA sums) equals the Pallas kernels."""
    t, d, h, kv_h, causal, window, sink, bq, bk = CASES[name]
    q, k, v, g = inputs(t, d=d, h=h, kv_h=kv_h)
    before = A.launches()
    got = port_grads(q, k, v, g, lambda q, k, v: A.FlashAttentionFn.apply(
        q, k, v, causal, d ** -0.5, bq, bk, A.check_window(causal, window),
        sink))
    assert_matches(got, interpret_results(name))
    assert A.launches() == before  # the plain path launches no kernel


@pytest.mark.parametrize("causal,window,sink", [
    (True, None, 0), (False, None, 0), (True, 24, 0), (True, 24, 4)])
def test_attention_lse_matches_xla(causal, window, sink):
    q, k, v, _ = inputs(100, h=4, kv_h=2, seed=3)
    kw, vw = (np.repeat(x, 2, axis=1) for x in (k, v))
    want_o, want_lse = xla_attention_lse(q, kw, vw, causal=causal,
                                         window=window, sink=sink)
    got_o, got_lse = A.flash_forward(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), scale=16 ** -0.5,
        causal=causal, window=window, sink=sink, block_q=128)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=ATOL_OUT)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=ATOL_OUT)


# (t, d, h, kv_h, causal, block_q, block_k): flash_attention_lse, the ring
# hop primitive, with cotangents on both outputs
LSE_CASES = {
    "causal": (128, 16, 2, 2, True, 64, 64),
    "noncausal": (128, 16, 2, 2, False, 64, 64),
    "padded_causal": (100, 16, 2, 2, True, 64, 64),
    "gqa_noncausal": (65, 16, 4, 2, False, 64, 64),
}


def _lse_grads(q, k, v, g, g_lse, fn):
    """(o, lse, dq, dk, dv) of fn(q, k, v) -> (o, lse) for cotangents
    (g, g_lse)."""
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = fn(qt, kt, vt)
    torch.autograd.backward((out, lse), (torch.tensor(g), torch.tensor(g_lse)))
    return [x.detach().numpy() for x in (out, lse, qt.grad, kt.grad, vt.grad)]


@pytest.mark.parametrize("entry", ["public", "autograd_function"])
@pytest.mark.parametrize("name", list(LSE_CASES))
def test_flash_attention_lse_matches_pallas_interpret(name, entry):
    """Both cotangents: out and lse within 2e-5, gradients 1e-4 of the
    Pallas kernels in interpret mode.  "public" is `flash_attention_lse`
    on CPU tensors (plain attention_lse under autograd);
    "autograd_function" is `FlashAttentionLseFn`, whose wrappers compute
    the kernels' plain versions here: its backward's delta' = rowsum(dO *
    O) - dlse is what the card's kernels are given."""
    t, d, h, kv_h, causal, bq, bk = LSE_CASES[name]
    q, k, v, g = inputs(t, d=d, h=h, kv_h=kv_h, seed=5)
    g_lse = np.random.RandomState(6).randn(2, h, t).astype(np.float32)
    want = flash_attention_lse_grads_interpret(q, k, v, g, g_lse, causal,
                                               None, bq, bk)
    if entry == "public":
        def fn(q, k, v):
            return A.flash_attention_lse(q, k, v, causal)
    else:
        def fn(q, k, v):
            return A.FlashAttentionLseFn.apply(q, k, v, causal, d ** -0.5,
                                               bq, bk)
    got = _lse_grads(q, k, v, g, g_lse, fn)
    for label, a, b, tol in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                                (ATOL_OUT,) * 2 + (ATOL_GRAD,) * 3):
        assert a.shape == np.asarray(b).shape, label
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, err_msg=label)


@pytest.mark.parametrize("used", ["out", "lse"])
def test_flash_attention_lse_unused_output_counts_as_zeros(used):
    """Autograd hands None for an output the loss does not read;
    FlashAttentionLseFn's backward takes it as a zero cotangent."""
    q, k, v, g = inputs(64, h=4, kv_h=2, seed=7)
    g_lse = np.random.RandomState(8).randn(2, 4, 64).astype(np.float32)
    zeros = {"out": (g, np.zeros_like(g_lse)),
             "lse": (np.zeros_like(g), g_lse)}[used]
    want = _lse_grads(q, k, v, *zeros,
                      lambda q, k, v: A.attention_lse(
                          q, *A.repeat_kv(q, k, v), causal=True))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out, lse = A.FlashAttentionLseFn.apply(*leaves, True, 16 ** -0.5, 64, 64)
    if used == "out":
        out.backward(torch.tensor(g))
    else:
        lse.backward(torch.tensor(g_lse))
    for a, b in zip((x.grad.numpy() for x in leaves), want[2:]):
        np.testing.assert_allclose(a, b, atol=ATOL_GRAD)


def test_bf16_inputs_within_bf16_noise_of_f32_reference():
    """bf16 q/k/v/g through the port (plain path) and the f32 closed-form
    gradients of the JAX reference agree within bf16 noise."""
    q, k, v, g = inputs(128, d=32, seed=3)
    qt, kt, vt = (torch.tensor(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    out = A.flash_attention(qt, kt, vt, True)
    out.backward(torch.tensor(g).bfloat16())
    assert out.dtype == torch.bfloat16 and qt.grad.dtype == torch.bfloat16

    def ref(q, k, v):
        return xla_attention_lse(q, k, v, causal=True)[0]

    want, vjp = jax.vjp(ref, q, k, v)
    wants = (want,) + vjp(jnp.asarray(g))
    for got, w in zip((out, qt.grad, kt.grad, vt.grad), wants):
        np.testing.assert_allclose(got.float().detach().numpy(),
                                   np.asarray(w), atol=0.06, rtol=0.06)


def test_validators_match_the_jax_package():
    q = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        A.flash_attention(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="causal"):
        A.flash_attention(q, q, q, False, window=4)
    with pytest.raises(ValueError, match="positive"):
        A.flash_attention(q, q, q, True, window=-4)
    with pytest.raises(ValueError, match="window"):
        A.flash_attention(q, q, q, True, sink=2)
    with pytest.raises(ValueError, match="sink must be >= 0"):
        A.check_sink(8, -1)
    assert A.check_window(True, 0) is None and A.check_sink(None, 0) == 0
    kv = torch.arange(2.0).reshape(1, 2, 1, 1)
    widened, _ = A.repeat_kv(torch.zeros(1, 4, 1, 1), kv, kv)
    assert widened.flatten().tolist() == [0.0, 0.0, 1.0, 1.0]


def test_default_blocks_env_contract(monkeypatch):
    monkeypatch.delenv("TPUJOB_FLASH_BLOCK_Q", raising=False)
    monkeypatch.delenv("TPUJOB_FLASH_BLOCK_K", raising=False)
    assert A.default_blocks(None, None) == (128, 128)
    assert A.default_blocks(256, None) == (256, 128)
    monkeypatch.setenv("TPUJOB_FLASH_BLOCK_Q", "512")
    monkeypatch.setenv("TPUJOB_FLASH_BLOCK_K", "256")
    assert A.default_blocks(None, None) == (512, 256)
    assert A.default_blocks(64, 64) == (64, 64)  # explicit args win
    monkeypatch.setenv("TPUJOB_FLASH_BLOCK_Q", "abc")
    with pytest.raises(ValueError, match="TPUJOB_FLASH_BLOCK_Q"):
        A.default_blocks(None, 64)
    monkeypatch.setenv("TPUJOB_FLASH_BLOCK_K", "100")
    with pytest.raises(ValueError, match="TPUJOB_FLASH_BLOCK_K=100"):
        A.default_blocks(64, None)


def test_unsupported_device_raises():
    q = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        A.flash_attention(q, q, q)


# The tenth slice: what the CUDA kernels now take (dtypes, head dims, any
# scale, any batch*heads, every block size).  On CPU tensors the wrappers
# compute their kernels' plain versions, so these hold the plumbing around
# the kernels (dtypes kept, head dims not a multiple of 8, blocks) against
# the Pallas kernels in interpret mode; the kernels themselves are held on
# the card (tests/test_torch_kernels_cuda.py).

JAX_CONTRACT_Q = range(8, 1025, 8)       # TPUJOB_FLASH_BLOCK_Q: multiples of 8
JAX_CONTRACT_K = range(128, 1025, 128)   # TPUJOB_FLASH_BLOCK_K: of 128
PORT_CONTRACT_K = range(64, 1025, 64)    # the port's superset: of 64


def test_resolve_tiles_maps_every_contract_value_onto_an_instantiation():
    built = A.instantiations()
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for d in (8, 64, 72, 100, 128):
            for bq in JAX_CONTRACT_Q:
                for bk in PORT_CONTRACT_K:
                    tiles = A.resolve_tiles(bq, bk, d, dtype)
                    for kernel in ("fwd", "dq", "dkv"):
                        assert (kernel, name, A.head_class(d),
                                *getattr(tiles, kernel)) in built
    assert set(JAX_CONTRACT_K) <= set(PORT_CONTRACT_K)


@pytest.mark.parametrize("d,want", [
    (64, A.Tiles(fwd=(128, 128), dq=(128, 128), dkv=(128, 64))),
    (128, A.Tiles(fwd=(128, 64), dq=(128, 64), dkv=(128, 32))),
])
def test_the_default_blocks_keep_the_tiles_the_kernels_ran(d, want):
    """(128, 128) resolves to the tiles the kernels ran before they took
    block pairs (query tiles of 128 rows; key steps 128 at head_dim 64 and
    64 at 128; dk/dv 128 keys with query steps 64 and 32), in bf16 and
    fp16; the blocks the TPU tuner writes and the smallest Q block map to
    the nearest tiles."""
    for dtype in (torch.bfloat16, torch.float16):
        assert A.resolve_tiles(128, 128, d, dtype) == want
    assert A.resolve_tiles(256, 512, 64, torch.bfloat16) == A.Tiles(
        fwd=(128, 128), dq=(128, 128), dkv=(128, 64))
    assert A.resolve_tiles(8, 128, 64, torch.bfloat16) == A.Tiles(
        fwd=(64, 128), dq=(64, 128), dkv=(128, 32))
    assert A.resolve_tiles(128, 128, d, torch.float32) == A.Tiles(
        *(A.F32_TILE,) * 3)


def test_default_blocks_take_a_key_block_of_64(monkeypatch):
    """TPUJOB_FLASH_BLOCK_K takes multiples of 64 (a tuned key tile of 64
    travels through the env), a superset of the JAX contract's 128."""
    monkeypatch.setenv("TPUJOB_FLASH_BLOCK_Q", "32")
    monkeypatch.setenv("TPUJOB_FLASH_BLOCK_K", "64")
    assert A.default_blocks(None, None) == (32, 64)
    monkeypatch.setenv("TPUJOB_FLASH_BLOCK_K", "96")
    with pytest.raises(ValueError, match="multiple of 64"):
        A.default_blocks(None, None)


@pytest.mark.parametrize("dtype,d,b,h", [
    (torch.float16, 32, 2, 4),
    (torch.float32, 96, 2, 4),
    (torch.bfloat16, 100, 2, 4),
    (torch.bfloat16, 8, 2, 4),
    (torch.float32, 128, 2, 4),
    (torch.bfloat16, 64, 4400, 16),  # batch*heads 70,400
])
def test_check_cuda_takes_what_the_pallas_kernels_take(dtype, d, b, h):
    """`_check_cuda`, called on CPU tensors (it reads only shapes, dtypes
    and layouts; T 4 keeps B*H 70,400 small), takes every dtype, head dim
    up to 128 and batch*heads that the Pallas kernels take."""
    q = torch.empty(b, h, 4, d, dtype=dtype)
    kv = torch.empty(b, h // 2, 4, d, dtype=dtype)
    rows = torch.empty(b, h, 4)
    A._check_cuda(q, kv, kv, q, rows, rows)


def test_check_cuda_rejects_what_no_kernel_takes():
    q = torch.empty(1, 2, 64, 0, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim >= 1, got 0"):
        A._check_cuda(q, q, q)
    q = torch.empty(1, 2, 64, 64, dtype=torch.float64)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        A._check_cuda(q, q, q)
    with pytest.raises(ValueError, match="one dtype"):
        A._check_cuda(q.float(), q.half(), q.half())


# fp16: the port's plain forward rounds P to fp16 before P.V where the
# Pallas kernel keeps it in f32 (and both round the outputs to fp16): a few
# units in the last place of fp16 outputs of size ~1 (measured up to 2e-3)
ATOL_F16 = 5e-3


def _low_precision_parity(q, k, v, g, dtype, causal, bq, bk):
    """The Pallas kernels in interpret mode and FlashAttentionFn (the
    kernels' plain versions here) on the same inputs rounded to dtype."""
    import jax.numpy as jnp

    np_dtype = {torch.float16: np.float16, torch.float32: np.float32}[dtype]
    q, k, v, g = (x.astype(np_dtype) for x in (q, k, v, g))
    want = flash_attention_grads_interpret(
        *(jnp.asarray(x) for x in (q, k, v, g)), causal, None, bq, bk)
    got = port_grads(q, k, v, g, lambda q, k, v: A.FlashAttentionFn.apply(
        q, k, v, causal, q.shape[-1] ** -0.5, bq, bk, None, 0))
    tol = ATOL_F16 if dtype == torch.float16 else ATOL_GRAD
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == np_dtype and a.shape == b.shape, name
        np.testing.assert_allclose(a.astype(np.float32),
                                   np.asarray(b, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32],
                         ids=["fp16", "f32"])
@pytest.mark.parametrize("d", [32, 96, 100])
def test_fp16_and_f32_match_pallas_interpret(dtype, d):
    """fp16 and f32 inputs at head dims 32 (on the 64 class), 96 (on 128)
    and 100 (padded to 104 on the card), causal, T 100, GQA 4/2."""
    _low_precision_parity(*inputs(100, d=d, h=4, kv_h=2, seed=11), dtype,
                          True, 64, 64)


@pytest.mark.parametrize("bq,bk", jax_autotune.DEFAULT_CANDIDATES)
def test_every_block_pair_of_the_jax_tuner_matches_pallas_interpret(bq, bk):
    """The pairs the TPU tuner searches (128..512; blocks above T 300 pad
    the Pallas grid) through FlashAttentionFn, f32."""
    q, k, v, g = inputs(300, seed=12)
    want = flash_attention_grads_interpret(q, k, v, g, True, None, bq, bk)
    got = port_grads(q, k, v, g, lambda q, k, v: A.FlashAttentionFn.apply(
        q, k, v, True, 16 ** -0.5, bq, bk, None, 0))
    assert_matches(got, want)
