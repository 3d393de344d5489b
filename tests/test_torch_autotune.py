"""The port's block autotuner (`tf_operator_tpu_torch.ops.autotune`), the
twin of `tests/test_ops.py::TestAutotune`.

On the CPU `flash_attention` runs the plain path, so every candidate times
the same function and ties (the reference times XLA off the TPU the same
way): the value is in the machinery — the search, the filter of blocks
larger than T, the in-process and file caches, and the kernel-source hash
in the key.  The last test runs the JAX tuner and the port's side by side
with the same arguments.
"""
import json

import pytest
import torch

from tf_operator_tpu.ops import autotune as jax_autotune
from tf_operator_tpu_torch.ops import attention as A
from tf_operator_tpu_torch.ops import autotune

torch.set_num_threads(1)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("TPUJOB_AUTOTUNE_CACHE", str(path))
    autotune._CACHE.clear()
    yield path
    autotune._CACHE.clear()


def test_returns_best_and_caches(cache):
    result = autotune.tune_flash_blocks(
        1, 2, 64, 8, reps=1, candidates=[(128, 128), (64, 64)])
    # 128 > t = 64 is filtered; the 64 x 64 candidate must win by default
    assert result["block_q"] == 64 and result["block_k"] == 64
    assert result["ms"] > 0
    (row,) = result["table"]
    # at T 64 in bf16 all three kernels take the encoders' kernels
    # (attention.short_route), whatever the blocks
    assert row["tiles"] == {"fwd": [256, 128], "dq": [256, 64],
                            "dkv": [256, 64]}
    # in-process cache: the same signature returns the same object
    again = autotune.tune_flash_blocks(
        1, 2, 64, 8, reps=1, candidates=[(128, 128), (64, 64)])
    assert again is result
    # persistent cache: a fresh in-process cache loads from the file
    autotune._CACHE.clear()
    loaded = autotune.tune_flash_blocks(
        1, 2, 64, 8, reps=1, candidates=[(128, 128), (64, 64)])
    assert loaded == result and loaded is not result


def test_kernel_edit_invalidates_persisted_cache(cache, monkeypatch):
    """A poisoned file entry is served while the kernels are unchanged
    (the file is read), and a changed kernel hash searches again and adds
    an entry beside the old one."""
    args = (1, 2, 64, 8)
    result = autotune.tune_flash_blocks(*args, reps=1, candidates=[(64, 64)])
    assert "block_q" in result

    table = json.loads(cache.read_text())
    (key,) = table.keys()
    assert autotune._kernel_source_hash() in key
    table[key]["ms"] = 123456.0
    cache.write_text(json.dumps(table))
    autotune._CACHE.clear()
    served = autotune.tune_flash_blocks(*args, reps=1, candidates=[(64, 64)])
    assert served["ms"] == 123456.0

    autotune._CACHE.clear()
    monkeypatch.setattr(autotune, "_KERNEL_HASH", "deadbeefdeadbeef")
    fresh = autotune.tune_flash_blocks(*args, reps=1, candidates=[(64, 64)])
    assert fresh["ms"] != 123456.0
    assert len(json.loads(cache.read_text())) == 2


@pytest.mark.parametrize("edit", ["attention.py", "csrc"])
def test_kernel_hash_covers_the_wrapper_and_every_kernel_source(
        edit, tmp_path, monkeypatch):
    """The hash reads ops/attention.py and `_build.source_digest` (every
    file under ops/csrc/): an edit to either changes it."""
    from tf_operator_tpu_torch.ops import _build

    monkeypatch.setattr(autotune, "_KERNEL_HASH", None)
    before = autotune._kernel_source_hash()
    if edit == "csrc":
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for path in _build.CSRC.iterdir():
            (csrc / path.name).write_bytes(path.read_bytes())
        (csrc / "hopper.cuh").write_text(
            (csrc / "hopper.cuh").read_text() + "\n// edited\n")
        monkeypatch.setattr(_build, "CSRC", csrc)
    else:
        copy = tmp_path / "attention.py"
        copy.write_text(open(A.__file__).read() + "\n# edited\n")
        monkeypatch.setattr(A, "__file__", str(copy))
    monkeypatch.setattr(autotune, "_KERNEL_HASH", None)
    assert autotune._kernel_source_hash() != before


def test_a_candidate_that_raises_is_an_error_row(cache):
    """Like the reference, a candidate that raises is recorded, not
    dropped; with none left the result says so."""
    result = autotune.tune_flash_blocks(1, 2, 64, 0, reps=1,
                                        candidates=[(64, 64)])
    assert set(result) == {"error", "table"}
    (row,) = result["table"]
    assert "head_dim" in row["error"] and "ms" not in row


def test_default_candidates_reach_every_instantiation():
    """One pair for each distinct set of resolved tiles at head_dim 64,
    and every instantiation of the tensor-core kernels (each head-dim
    class, the sliced kernels above 256, the cluster dq and dk/dv up to
    head dim 1024 and the sliced ones above it, and at T <= 256 the
    encoders' kernels) reached by one."""
    reached, sets = set(), set()
    for dtype in (torch.bfloat16, torch.float16):
        for d in (64, 128, 256, 512, 2112):
            for bq, bk in autotune.DEFAULT_CANDIDATES:
                tiles = A.resolve_tiles(bq, bk, d, dtype)
                if d == 64:
                    sets.add((dtype, tiles))
                for t_tiles in (tiles, A.resolve_tiles(bq, bk, d, dtype,
                                                       197)):
                    for kernel in ("fwd", "dq", "dkv"):
                        route = (A.CLUSTER if kernel != "fwd"
                                 and A.cluster_route(d, dtype)
                                 else A.head_class(d))
                        reached.add((kernel,
                                     str(dtype).removeprefix("torch."),
                                     route, *getattr(t_tiles, kernel)))
    assert len(sets) == 2 * len(autotune.DEFAULT_CANDIDATES)
    assert reached == {x for x in A.instantiations() if x[1] != "float32"}


@pytest.mark.parametrize("t,candidates", [
    (64, [(128, 128), (64, 64)]),
    (200, [(128, 128), (256, 128), (128, 256), (64, 64)]),
    (128, None),
])
def test_the_two_tuners_drop_the_same_candidates(t, candidates, tmp_path,
                                                 monkeypatch):
    """The JAX tuner and the port's, run side by side on the CPU with the
    same arguments, time the same candidates (both skip a block larger
    than T) and return the same keys; their cache keys hold the same
    fields but the hash (the port's also covers its kernel sources) and
    the backend name."""
    monkeypatch.delenv("TPUJOB_AUTOTUNE_CACHE", raising=False)
    if candidates is None:
        candidates = jax_autotune.DEFAULT_CANDIDATES
    jax_autotune._CACHE.clear()
    autotune._CACHE.clear()
    try:
        want = jax_autotune.tune_flash_blocks(1, 2, t, 8, reps=1,
                                              candidates=candidates)
        got = autotune.tune_flash_blocks(1, 2, t, 8, reps=1,
                                         candidates=candidates)
        assert set(got) == set(want)
        assert [(r["block_q"], r["block_k"]) for r in got["table"]] == \
            [(r["block_q"], r["block_k"]) for r in want["table"]]
        assert all(set(r) - {"tiles"} == set(w)
                   for r, w in zip(got["table"], want["table"]))
        (jax_sig,), (sig,) = jax_autotune._CACHE, autotune._CACHE
        assert sig[1:-1] == jax_sig[1:-1] and sig[0] == jax_sig[0] == "cpu"
    finally:
        jax_autotune._CACHE.clear()
        autotune._CACHE.clear()
