"""The port's collective inventory (`tf_operator_tpu_torch/analysis/hlo.py`)
in one 4-rank gloo world (`torch_dist_worker.World`, one process per rank,
`torch.set_num_threads(1)`): a scripted sequence of every recorded entry
point; the four workloads with ZeRO on and off; the fixtures under
`tests/torch_lint_fixtures/`; the captures that must raise (a collective
past the wrappers, a rank that diverges).  The JAX package's capture of
the same workloads runs here, on 4 of conftest's 8 virtual CPU devices,
for the plan-level numbers the port must reproduce exactly.  Last, the
CLI in subprocesses.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from tf_operator_tpu.analysis import hlo as jhlo
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu_torch.analysis import hlo
from torch_dist_worker import World

REPO = Path(__file__).resolve().parent.parent
MANIFEST = REPO / "tf_operator_tpu_torch" / "analysis" / \
    "collective-manifest.json"
WORLD = 4

BAD = {
    "bad_hlo_plan_drift": hlo.RULE_HLO_PLAN_DRIFT,
    "bad_hlo_plan_drift_unreduced": hlo.RULE_HLO_PLAN_DRIFT,
    "bad_hlo_replicated_optstate": hlo.RULE_HLO_REPLICATED_OPTSTATE,
    "bad_hlo_sync_collective": hlo.RULE_HLO_SYNC_COLLECTIVE,
    "bad_hlo_memory_infeasible": hlo.RULE_HLO_MEMORY_INFEASIBLE,
}

# the JAX package's numbers at N = 4 (plan entries, sharded entries,
# optimizer-state bytes and parameter bytes per device)
JAX_NUMBERS = {
    "lm": (36, 36, 43_520, 87_040),
    "resnet": (62, 62, 11_180_616, 44_722_464),
    "bert": (43, 42, 1_991_248, 3_982_472),
    "vit": (40, 40, 64_208, 128_416),
}


def _cases():
    cases = [{"name": "script", "what": "script"}]
    for w in hlo.TRAIN_WORKLOADS:
        for zero in (True, False):
            cases.append({"name": f"{w}-zero{int(zero)}", "what": "workload",
                          "workload": w, "zero": zero})
    for stem in list(BAD) + ["suppressed_hlo_ok"]:
        cases.append({"name": stem, "what": "fixture",
                      "path": f"tests/torch_lint_fixtures/{stem}.py"})
    for what in ("bypass", "functional", "diverge"):
        cases.append({"name": what, "what": what})
    return [dict(c, kind="hlo") for c in cases]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results (decoded), the JAX captures made meanwhile."""
    w = World(tmp_path_factory.mktemp("hlo"), WORLD,
              {"kind": "hlo", "cases": _cases()})
    jax_caps = _jax_captures()
    ranks = [{name: json.loads(r["json"]) for name, r in res.items()}
             for res in w.results(timeout=600)]
    return ranks, jax_caps


def _jax_captures():
    """The JAX package's capture of each workload over {"dp": 4} on 4 of
    conftest's 8 virtual devices (its `build_mesh` insists on every
    device; the patch hands it the first 4)."""
    original = jmesh.build_mesh

    def four(axes, devices=None):
        return original(axes, devices=jax.devices()[:WORLD])

    jmesh.build_mesh = four
    try:
        return {w: jhlo.capture_workload(w, WORLD)
                for w in hlo.TRAIN_WORKLOADS}
    finally:
        jmesh.build_mesh = original


def test_scripted_inventory(world):
    """Every entry point recorded in call order, on every rank: kind,
    operand and result shapes and dtypes, group size and count, async_op,
    the caller; the async all-reduce never waited on counted unpaired."""
    ranks, _ = world
    f32 = lambda *d: ["f32", list(d)]  # noqa: E731
    want = [
        ["all-reduce", [f32(16, 32)], [f32(16, 32)], 4, 1, False],
        ["all-gather", [f32(16, 32)], [f32(64, 32)], 4, 1, True],
        ["reduce-scatter", [f32(16, 32)], [f32(4, 32)], 4, 1, False],
        ["all-gather", [f32(8)], [f32(8)] * 4, 4, 1, False],
        ["all-to-all", [f32(16, 32)], [f32(16, 32)], 4, 1, False],
        ["broadcast", [["s64", [3]]], [["s64", [3]]], 4, 1, False],
        ["all-reduce", [f32(6)], [f32(6)], 2, 2, False],
        ["collective-permute", [f32(5)], [f32(5)], 4, 1, True],
        ["collective-permute", [f32(2)], [], 4, 1, True],
        ["collective-permute", [], [f32(2)], 4, 1, True],
        ["all-reduce", [f32(1)], [f32(1)], 4, 1, True],
    ]
    for rank in ranks:
        got = rank["script"]
        assert [op[:6] for op in got["ops"]] == want
        callers = [op[6] for op in got["ops"]]
        assert all(c.startswith("tests/torch_dist_worker.py:")
                   for i, c in enumerate(callers) if i != 7), callers
        assert callers[7].startswith("tf_operator_tpu_torch/parallel/dist.py:")
        assert got["unpaired"] == 1
        sig = got["signature"]
        assert sig["all-gather"] == {"count": 2, "syncCount": 1,
                                     "totalBytes": 64 * 32 * 4 + 4 * 8 * 4,
                                     "groupSizes": [4]}
        assert sig["all-reduce"]["groupSizes"] == [2, 4]
        assert sig["collective-permute"]["syncCount"] == 0
        # the wrapped collectives still ran: x summed over the ranks in
        # place, then four copies of it gathered
        n = 16 * 32
        assert got["gathered"] == 4 * (4 * n * (n - 1) / 2 + n * (0 + 1 + 2 + 3))


@pytest.mark.parametrize("name", hlo.TRAIN_WORKLOADS)
def test_workload_with_zero_is_clean_and_holds_the_jax_plan(world, name):
    """No finding; plan entries, sharded entries, optimizer-state and
    parameter bytes per rank equal the JAX package's exactly; every
    all-gather over a group of 4, at least one per sharded entry, a
    reduction; the update pairs map one to one onto JAX's
    `plan_update_pairs` (element counts, the gather over the plan's dim);
    every rank the same signature."""
    ranks, jax_caps = world
    got = ranks[0][f"{name}-zero1"]
    assert got["findings"] == []
    sig = got["signature"]
    sharded = JAX_NUMBERS[name][1]
    assert (sig["plan"]["entries"], sig["plan"]["shardedEntries"],
            sig["optStateBytesPerDevice"], sig["paramsBytesPerDevice"]) == \
        JAX_NUMBERS[name]
    jcap = jax_caps[name]
    jsig = jhlo.workload_signature(jcap)
    assert (jsig["plan"]["entries"], jsig["plan"]["shardedEntries"],
            jsig["optStateBytesPerDevice"],
            jsig["paramsBytesPerDevice"]) == JAX_NUMBERS[name]
    gathers = sig["collectives"]["all-gather"]
    assert gathers["groupSizes"] == [4]
    assert gathers["count"] >= sharded
    assert sig["collectives"]["reduce-scatter"]["count"] + \
        sig["collectives"].get("all-reduce", {}).get("count", 0) > 0
    assert len(got["pairs"]) == len(jcap.update_pairs) == sharded
    for (path, shard, base, overlap), jpair in zip(got["pairs"],
                                                   jcap.update_pairs):
        assert np.prod(shard) == np.prod(jpair.shard_dims), path
        assert np.prod(base) == np.prod(jpair.base_dims), path
        assert base[0] == WORLD * shard[0] and base[1:] == shard[1:], path
        assert overlap is jpair.overlap is False
    for rank in ranks[1:]:
        assert rank[f"{name}-zero1"]["signature"] == sig


@pytest.mark.parametrize("name", hlo.TRAIN_WORKLOADS)
def test_workload_without_zero_has_no_plan_and_no_finding(world, name):
    ranks, _ = world
    got = ranks[0][f"{name}-zero0"]
    assert got["findings"] == [] and not got["plan"]
    assert "plan" not in got["signature"]
    # dense: no weight-update gather, the gradients all-reduced
    assert "all-gather" not in got["signature"]["collectives"]
    assert got["signature"]["collectives"]["all-reduce"]["count"] >= 2
    assert got["signature"]["optStateBytesPerDevice"] == \
        JAX_NUMBERS[name][3] * (1 if name == "resnet" else 2)


def test_live_signature_is_the_committed_manifest(world):
    ranks, _ = world
    committed = json.loads(MANIFEST.read_text())
    assert committed["numDevices"] == WORLD
    assert committed["zeroShardWeightUpdate"] is True
    assert committed["schema"] == hlo.HLO_MANIFEST_SCHEMA
    for name in hlo.TRAIN_WORKLOADS:
        sig = ranks[0][f"{name}-zero1"]["signature"]
        assert committed["workloads"][name] == {
            "hash": hlo.signature_hash(sig), "signature": sig}


@pytest.mark.parametrize("stem", list(BAD))
def test_bad_fixture_fires_exactly_once(world, stem):
    ranks, _ = world
    for rank in ranks:
        (cap,) = rank[stem]
        assert [f[0] for f in cap["findings"]] == [BAD[stem]]
        assert cap["findings"][0][1] == f"tests/torch_lint_fixtures/{stem}.py"


def test_suppressed_fixtures_fire_nothing(world):
    ranks, _ = world
    caps = ranks[0]["suppressed_hlo_ok"]
    assert len(caps) == 5
    assert all(cap["findings"] == [] for cap in caps)


@pytest.mark.parametrize("what", ["bypass", "functional"])
def test_a_collective_past_the_wrappers_raises(world, what):
    ranks, _ = world
    for rank in ranks:
        err = rank[what]["error"]
        assert err and "went past the recorder" in err, err


def test_a_diverging_rank_raises_on_every_rank(world):
    ranks, _ = world
    for rank in ranks:
        err = rank["diverge"]["error"]
        assert err and "rank 1 issued" in err and "part at" in err, err


def _cli(*argv, **env):
    """The CLI as a user runs it on the CPU: TPUJOB_FORCE_PLATFORM=cpu
    asks for gloo ranks; `env` adds to the environment, None removes."""
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "TPUJOB_FORCE_PLATFORM": "cpu", **env}
    env = {k: v for k, v in env.items() if v is not None}
    return subprocess.run(
        [sys.executable, "-m", "tf_operator_tpu_torch.analysis", *argv],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=600)


def test_cli_bad_fixture_exits_1_naming_its_rule():
    """N from TPUJOB_CPU_DEVICE_COUNT without --devices, the ranks started
    by the pod launcher, whose exit is rank 0's."""
    bad = _cli("--hlo", "tests/torch_lint_fixtures/bad_hlo_sync_collective.py",
               TPUJOB_CPU_DEVICE_COUNT="2", ANALYSIS_HLO_DEVICES=None)
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "[hlo-sync-collective]" in bad.stdout
    assert "1 HLO finding(s)" in bad.stdout
    assert "over 2 rank(s); cpu peak" in bad.stdout
    assert "pod launcher: exit 1" in bad.stdout


def test_cli_without_cuda_and_without_the_cpu_asked_for_exits_1():
    """No GPU visible and the CPU not asked for: the rank says so and the
    command exits 1, having captured nothing."""
    out = _cli("--hlo", "lm", TPUJOB_FORCE_PLATFORM=None,
               CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 1, out.stdout + out.stderr
    assert "hlo: no CUDA device is visible; set TPUJOB_FORCE_PLATFORM=cpu" \
        in out.stdout
    assert "HLO finding(s)" not in out.stdout


def test_cli_all_matches_the_committed_manifest(tmp_path):
    findings = tmp_path / "findings.json"
    ok = _cli("--hlo", "all", "--devices", str(WORLD), "--diff",
              str(MANIFEST), "--json", str(findings))
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 HLO finding(s) over 4" in ok.stdout
    assert "collective manifest matches" in ok.stdout
    doc = json.loads(findings.read_text())
    assert doc["count"] == 0 and doc["target"] == "hlo:all"
