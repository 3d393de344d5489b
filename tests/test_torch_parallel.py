"""Parity of the port's mesh, ring attention and Ulysses with the JAX
package's.

The mesh tests are the JAX `TestMesh` cases (tests/test_parallel.py) on
the port's layout over ranks, held against the JAX mesh over as many
virtual CPU devices.  The sequence-parallel cases run on one world of 4
gloo ranks (`torch_dist_worker.py`, one process per rank, f32): sp 2 as a
dp 2 x sp 2 mesh (both sp groups compute the case), sp 4 as one group.
Each rank attends its sequence shard; the shards of output and gradients
are put back together here and held against the JAX `ring_attention` /
`ulysses_attention` on the same inputs over a mesh of virtual CPU devices,
and against full attention.  Tolerances: 2e-5 on outputs, 1e-4 on
gradients (the JAX package's interpret-vs-XLA tolerances: the same
products summed in another order).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel.ring_attention import ring_attention as j_ring
from tf_operator_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from tf_operator_tpu_torch.parallel import mesh as M
from tf_operator_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_hops,
)
from torch_dist_worker import World

torch.set_num_threads(1)

ATOL_OUT = 2e-5
ATOL_GRAD = 1e-4
WORLD = 4


# ---------------------------------------------------------------------------
# the mesh (tests/test_parallel.py::TestMesh, over ranks)


def jax_mesh(axes, n):
    return jmesh.build_mesh(axes, devices=jax.devices()[:n])


@pytest.mark.parametrize("axes,n", [
    ({"dp": 2, "tp": 4}, 8), ({"tp": 2, "dp": 2, "sp": 2}, 8), (None, 8),
    ({"dp": 2, "sp": 2}, 4), ({"sp": 4}, 4), ({"dp": 1}, 1),
    ({"sp": 2, "zz": 2}, 4),
])
def test_build_mesh_matches_jax(axes, n):
    """Axis order, sizes and the row-major layout: rank r sits where
    device r sits in the JAX mesh."""
    ours, theirs = M.build_mesh(axes, n), jax_mesh(axes, n)
    assert ours.axis_names == theirs.axis_names
    assert ours.shape == dict(theirs.shape) and ours.size == n
    ids = np.vectorize(lambda d: d.id)(theirs.devices)
    for rank in range(n):
        where = np.argwhere(ids == rank)[0]
        assert [ours.coordinate(a, rank) for a in ours.axis_names] == \
            list(where)


def test_size_mismatch_raises_the_jax_message():
    with pytest.raises(ValueError) as theirs:
        jax_mesh({"dp": 3}, 8)
    with pytest.raises(ValueError) as ours:
        M.build_mesh({"dp": 3}, 8)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="require 2 devices, but 1"):
        M.build_mesh({"sp": 2})  # no process group: one rank


def test_env_mesh_and_local_batch(monkeypatch):
    monkeypatch.setenv("TPUJOB_MESH_SHAPE", json.dumps({"dp": 4, "tp": 2}))
    mesh = M.mesh_from_env(8)
    assert mesh.shape == {"dp": 4, "tp": 2} == dict(jmesh.mesh_from_env().shape)
    assert M.local_batch_size(32, mesh) == 8
    with pytest.raises(ValueError):
        M.local_batch_size(10, mesh)
    assert M.data_axes(M.build_mesh({"dp": 2, "fsdp": 2, "sp": 2}, 8)) == \
        ("dp", "fsdp")
    assert M.axis_size(mesh, "sp") == 1 and M.axis_size(mesh, "dp") == 4
    with pytest.raises(RuntimeError, match="without a process group"):
        mesh.group("dp")


# ---------------------------------------------------------------------------
# ring attention and Ulysses over 4 ranks


def _inputs(h, kv_h, t=32, d=16, b=2, seed=0):
    rng = np.random.RandomState(seed)
    shapes = ((b, h, t, d), (b, kv_h, t, d), (b, kv_h, t, d), (b, h, t, d))
    return [rng.randn(*s).astype(np.float32) for s in shapes]


# name -> (strategy, sp, causal, heads, kv heads, use_flash)
CASES = {}
for _strategy in ("ring", "ulysses"):
    for _sp in (2, 4):
        for _causal in (True, False):
            for _flash in (True, False):
                CASES[f"{_strategy}_sp{_sp}_{'causal' if _causal else 'full'}"
                      f"_{'flash' if _flash else 'einsum'}"] = (
                    _strategy, _sp, _causal, 4, 4, _flash)
# GQA: the ring moves grouped blocks; Ulysses keeps them grouped when the
# kv heads split over sp (2 / 2) and widens them when they do not (2 / 4)
CASES.update({
    "ring_gqa_sp2": ("ring", 2, True, 4, 2, True),
    "ring_gqa_sp4": ("ring", 4, True, 8, 2, True),
    "ulysses_gqa_grouped_sp2": ("ulysses", 2, True, 4, 2, True),
    "ulysses_gqa_widened_sp4": ("ulysses", 4, True, 4, 2, True),
})


@pytest.fixture(scope="module")
def world_results(tmp_path_factory):
    """Every case on one 4-rank world; per case, each rank's results."""
    cases = []
    for name, (strategy, sp, causal, h, kv_h, flash) in CASES.items():
        q, k, v, g = (torch.from_numpy(x) for x in _inputs(h, kv_h))
        cases.append(dict(name=name, strategy=strategy, sp=sp,
                          causal=causal, use_flash=flash, q=q, k=k, v=v,
                          g=g))
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(6, 6))
    cases.append(dict(name="ulysses_bad_heads", strategy="ulysses", sp=4,
                      causal=True, q=q, k=k, v=v, expect_error=True))
    ranks = World(tmp_path_factory.mktemp("sp_world"), WORLD,
                  dict(kind="attention", cases=cases)).results()
    return {name: [r[name] for r in ranks] for name in ranks[0]}


def _assemble(per_rank, key, sp):
    """Put the sp shards of the first sp group back in sequence order;
    every other group computed the same case and must agree."""
    first = [per_rank[r][key] for r in range(sp)]
    for r in range(sp, WORLD):
        assert torch.equal(per_rank[r][key], per_rank[r % sp][key])
    assert [int(per_rank[r]["sp_index"]) for r in range(sp)] == \
        list(range(sp))
    return torch.cat(first, dim=2).numpy()


def _jax_side(strategy, sp, causal, use_flash, q, k, v, g):
    """The JAX op's output and gradients, forward and backward in one
    compiled program."""
    mesh = jax_mesh({"sp": sp}, sp)
    fn = j_ulysses if strategy == "ulysses" else j_ring

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: fn(
            q, k, v, mesh, axis_name="sp", causal=causal,
            use_flash=use_flash), q, k, v)
        return (out, *vjp(g))

    return [np.asarray(x) for x in run(q, k, v, g)]


@pytest.mark.parametrize("name", list(CASES))
def test_sequence_parallel_matches_jax_and_full_attention(name,
                                                          world_results):
    strategy, sp, causal, h, kv_h, use_flash = CASES[name]
    q, k, v, g = _inputs(h, kv_h)
    got = [_assemble(world_results[name], key, sp)
           for key in ("out", "dq", "dk", "dv")]
    want = _jax_side(strategy, sp, causal, use_flash, q, k, v, g)
    for label, a, b, tol in zip(("out", "dq", "dk", "dv"), got, want,
                                (ATOL_OUT,) + (ATOL_GRAD,) * 3):
        assert a.shape == b.shape, label
        np.testing.assert_allclose(a, b, atol=tol, err_msg=label)

    # and full attention over the whole sequence (k/v widened for GQA)
    for label, a, b, tol in zip(("out", "dq", "dk", "dv"), got,
                                _full_attention(q, k, v, g, causal),
                                (ATOL_OUT,) + (ATOL_GRAD,) * 3):
        np.testing.assert_allclose(a, b, atol=tol, err_msg=label)


def _full_attention(q, k, v, g, causal):
    """Output and gradients of `reference_attention` over the whole
    sequence, k/v widened to q's heads."""
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    group = q.shape[1] // k.shape[1]
    out = reference_attention(leaves[0], *(x.repeat_interleave(group, 1)
                                           for x in leaves[1:]),
                              causal=causal)
    out.backward(torch.from_numpy(g))
    return [x.detach().numpy() for x in (out, *(x.grad for x in leaves))]


def test_ulysses_head_divisibility_error_matches_jax(world_results):
    q, k, v, _ = _inputs(6, 6)
    with pytest.raises(ValueError) as theirs:
        j_ulysses(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jax_mesh({"sp": 4}, 4), axis_name="sp")
    # the same text, the mesh axis named by what the port's op is given: a
    # process group, not an axis label
    want = str(theirs.value).replace("'sp' axis size",
                                     "sequence-parallel group size")
    assert want != str(theirs.value)
    for rank in world_results["ulysses_bad_heads"]:
        assert rank["error"] == want


@pytest.mark.parametrize("n,causal", [(2, True), (4, True), (4, False)])
def test_ring_hops_with_handed_blocks_equal_full_attention(n, causal):
    """The hop loop of every rank, its blocks handed over from the whole
    sequence in place of the shift (what the card's ring phase runs), put
    back together, equals full attention, gradients included."""
    q, k, v, g = _inputs(4, 2, t=48)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    t = q.shape[2] // n
    blocks = [(leaves[1][:, :, i * t:(i + 1) * t],
               leaves[2][:, :, i * t:(i + 1) * t]) for i in range(n)]
    outs = []
    for me in range(n):
        arriving = [blocks[(me - s) % n] for s in range(n)]
        outs.append(ring_hops(leaves[0][:, :, me * t:(me + 1) * t], me, n,
                              arriving, causal=causal))
    out = torch.cat(outs, dim=2)
    out.backward(torch.from_numpy(g))
    got = [x.detach().numpy() for x in (out, *(x.grad for x in leaves))]
    for a, b, tol in zip(got, _full_attention(q, k, v, g, causal),
                         (ATOL_OUT,) + (ATOL_GRAD,) * 3):
        np.testing.assert_allclose(a, b, atol=tol)
