"""The port's collective inventory rules (`tf_operator_tpu_torch/analysis/
hlo.py`) on canned captures, no process group: each of the JAX package's
rule cases (`tests/test_hlo_analysis.py::TestRules`), the signature and its
hash, the manifest's canonical text, the findings document against the
JAX package's, the admission math against the reference's over a grid of
sizes and meshes, and `ZeroShardingPlan.with_overlap` against JAX's.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from tf_operator_tpu import analysis as janalysis
from tf_operator_tpu.analysis import hlo as jhlo
from tf_operator_tpu.api.types import TPUTopology
from tf_operator_tpu.models import transformer as J
from tf_operator_tpu.parallel.mesh import build_mesh as j_build_mesh
from tf_operator_tpu.parallel.tp_rules import make_param_shardings
from tf_operator_tpu.train import zero as jzero
from tf_operator_tpu_torch import analysis
from tf_operator_tpu_torch.analysis import hlo
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models.convert import flax_param_map
from tf_operator_tpu_torch.parallel.mesh import build_mesh
from tf_operator_tpu_torch.train import zero as tzero


def op(kind, operand, result, asynchronous=False, group=4, name="x.0"):
    return hlo.CollectiveOp(
        kind=kind, name=name, result_shapes=(result,),
        operand_shapes=(operand,), bytes_moved=hlo.shape_bytes(result),
        num_groups=1, group_size=group, asynchronous=asynchronous,
        op_name="tf_operator_tpu_torch/parallel/shard.py:320")


# A step's inventory exercising every part the rules read: a sync
# gradient reduction of both sharded entries' whole gradients (one flat
# all-reduce, or ZeRO's reduce-scatter per entry), an async and a sync
# all-gather, and the state the rank holds.
def canned_program(reduction="all-reduce"):
    reductions = {
        "all-reduce": (op("all-reduce", ("f32", (64 * 32 + 32,)),
                          ("f32", (64 * 32 + 32,))),),
        "reduce-scatter": (
            op("reduce-scatter", ("f32", (64, 32)), ("f32", (16, 32))),
            op("reduce-scatter", ("f32", (32,)), ("f32", (8,)))),
        # the loss's all-reduce alone
        "loss-only": (op("all-reduce", ("f32", ()), ("f32", ())),),
        "none": (),
    }[reduction]
    collectives = reductions + (
        op("all-gather", ("f32", (16, 32)), ("f32", (64, 32)),
           asynchronous=True),
        op("all-gather", ("f32", (8,)), ("f32", (32,))),
    )
    return hlo.HloProgram(
        collectives=collectives,
        resident=(("f32", (16, 32)), ("f32", (8,)), ("s32", ())),
        unpaired_starts=0)


def make_capture(tmp_path, program=None, *, pairs=(), expected=(),
                 budget=0, memory=None, anchor_text="def main():\n"):
    """Synthetic HloCapture over a throwaway anchor file."""
    anchor = tmp_path / "anchor.py"
    anchor.write_text(anchor_text)
    plan = tzero.ZeroShardingPlan(axis="dp", num_shards=4, entries=())
    return hlo.HloCapture(
        workload="synthetic", num_devices=4, zero=True, plan=plan,
        program=program if program is not None else canned_program(),
        memory=memory, moments_per_param=2,
        expected_args=tuple(expected), update_pairs=tuple(pairs),
        opt_bytes_per_device=0, params_bytes_per_device=0,
        anchor_file=str(anchor), anchor_path="anchor.py", anchor_line=1,
        device_memory_budget_bytes=budget)


class TestRules:
    def pairs(self, overlap=False):
        return (hlo.PlanPair(shard_dims=(16, 32), base_dims=(64, 32),
                             overlap=overlap),
                hlo.PlanPair(shard_dims=(8,), base_dims=(32,),
                             overlap=overlap))

    def test_clean_program_no_findings(self, tmp_path):
        cap = make_capture(
            tmp_path, pairs=self.pairs(),
            expected=(("f32", (16, 32)), ("f32", (8,)), ("s32", ())))
        assert hlo.check_capture(cap) == []

    def test_plan_drift_missing_gather(self, tmp_path):
        # demand two gathers of the large entry; the step supplies one
        pairs = (hlo.PlanPair((16, 32), (64, 32), False),) * 2
        findings = hlo.check_capture(make_capture(tmp_path, pairs=pairs))
        assert [f.rule for f in findings] == [hlo.RULE_HLO_PLAN_DRIFT]
        assert "1 of 2" in findings[0].message
        assert "[16, 32]->[64, 32]x1" in findings[0].message

    def test_plan_drift_no_reduction(self, tmp_path):
        program = canned_program(reduction="none")
        findings = hlo.check_capture(make_capture(
            tmp_path, program=program, pairs=self.pairs()))
        assert [f.rule for f in findings] == [hlo.RULE_HLO_PLAN_DRIFT]
        assert "no gradient reduction" in findings[0].message

    def test_plan_drift_reductions_short_of_the_gradients(self, tmp_path):
        # the loss's all-reduce is a reduction, but it sums 4 B where the
        # plan owes both entries' gradients: (64 x 32 + 32) x 4 B
        findings = hlo.check_capture(make_capture(
            tmp_path, program=canned_program(reduction="loss-only"),
            pairs=self.pairs()))
        assert [f.rule for f in findings] == [hlo.RULE_HLO_PLAN_DRIFT]
        assert "sum 4 B, short of the sharded plan entries' 8320 B" in \
            findings[0].message
        # bf16 gradients owe half the bytes
        half = tuple(hlo.PlanPair(p.shard_dims, p.base_dims, False,
                                  dtype="bf16") for p in self.pairs())
        assert sum(p.grad_bytes for p in half) == 4160
        assert hlo.check_capture(make_capture(
            tmp_path, program=canned_program(reduction="loss-only"),
            pairs=half))[0].rule == hlo.RULE_HLO_PLAN_DRIFT

    def test_drift_accepts_reduce_scatter_form(self, tmp_path):
        # ZeRO's reduce-scatter satisfies the reduction demand
        findings = hlo.check_capture(make_capture(
            tmp_path, program=canned_program(reduction="reduce-scatter"),
            pairs=self.pairs()))
        assert findings == []

    def test_replicated_optstate(self, tmp_path):
        findings = hlo.check_capture(make_capture(
            tmp_path, pairs=self.pairs(),
            expected=(("f32", (16, 32)), ("f32", (8,)), ("f32", (2, 2)))))
        assert [f.rule for f in findings] == [
            hlo.RULE_HLO_REPLICATED_OPTSTATE]
        assert "f32[2, 2]x1" in findings[0].message

    def test_sync_collective_only_for_overlap_entries(self, tmp_path):
        # the canned (8,)->(32,) gather is synchronous: flagged only when
        # its plan entry promises overlap
        sync_pair = (hlo.PlanPair((8,), (32,), True),)
        findings = hlo.check_capture(make_capture(
            tmp_path, pairs=sync_pair, expected=(("f32", (8,)),)))
        assert [f.rule for f in findings] == [hlo.RULE_HLO_SYNC_COLLECTIVE]
        assert hlo.check_capture(make_capture(
            tmp_path, pairs=(hlo.PlanPair((8,), (32,), False),),
            expected=(("f32", (8,)),))) == []

        # the async (16,32)->(64,32) gather satisfies overlap: clean
        async_pair = (hlo.PlanPair((16, 32), (64, 32), True),)
        assert hlo.check_capture(make_capture(
            tmp_path, pairs=async_pair,
            expected=(("f32", (16, 32)),))) == []

    def test_memory_infeasible_budget(self, tmp_path):
        memory = hlo.MemoryStats(resident_bytes=1000, peak_bytes=1600,
                                 device="cuda")
        cap = make_capture(tmp_path, budget=1024, memory=memory)
        findings = hlo.check_capture(cap)
        assert [f.rule for f in findings] == [hlo.RULE_HLO_MEMORY_INFEASIBLE]
        assert "peak 1600 B exceeds" in findings[0].message
        assert hlo.check_capture(
            make_capture(tmp_path, budget=10_000, memory=memory)) == []
        # no declared budget: never
        assert hlo.check_capture(make_capture(tmp_path, memory=memory)) == []

    def test_suppression_comment(self, tmp_path):
        pairs = (hlo.PlanPair((16, 32), (64, 32), False),) * 2
        cap = make_capture(
            tmp_path, pairs=pairs,
            anchor_text="def main():  # lint: allow(hlo-plan-drift)\n")
        assert hlo.check_capture(cap) == []

    def test_rules_filter(self, tmp_path):
        pairs = (hlo.PlanPair((16, 32), (64, 32), False),) * 2
        cap = make_capture(tmp_path, pairs=pairs)
        assert hlo.check_capture(
            cap, rules=[hlo.RULE_HLO_SYNC_COLLECTIVE]) == []
        assert len(hlo.check_capture(
            cap, rules=[hlo.RULE_HLO_PLAN_DRIFT])) == 1

    def test_no_plan_no_plan_rules(self, tmp_path):
        cap = make_capture(tmp_path, program=canned_program("none"),
                           pairs=self.pairs(), expected=(("f32", (3,)),))
        cap.plan = None
        assert hlo.check_capture(cap) == []

    def test_rule_ids_are_the_jax_packages(self):
        assert hlo.HLO_RULES == jhlo.HLO_RULES
        kinds = {kind for kind, _, _ in hlo._ENTRY_POINTS.values()}
        assert kinds == set(jhlo.COLLECTIVE_KINDS) | {"broadcast"}


class TestSignature:
    def test_signature_and_hash_stable(self):
        sig = hlo.collective_signature(canned_program())
        assert sig["all-reduce"] == {"count": 1, "syncCount": 1,
                                     "totalBytes": (64 * 32 + 32) * 4,
                                     "groupSizes": [4]}
        assert sig["all-gather"]["count"] == 2
        assert sig["all-gather"]["syncCount"] == 1  # one async, one sync
        assert sig["all-gather"]["groupSizes"] == [4]
        assert hlo.signature_hash(sig) == hlo.signature_hash(
            hlo.collective_signature(canned_program()))
        assert len(hlo.signature_hash(sig)) == 64

    def test_signature_is_the_jax_signature_of_the_same_inventory(self):
        """The JAX package's `collective_signature` over the same ops
        (its CollectiveOp) gives the same document."""
        ops = tuple(jhlo.CollectiveOp(
            kind=o.kind, name=o.name, result_shapes=o.result_shapes,
            operand_shapes=o.operand_shapes, bytes_moved=o.bytes_moved,
            num_groups=o.num_groups, group_size=o.group_size,
            asynchronous=o.asynchronous) for o in canned_program().collectives)
        theirs = jhlo.collective_signature(jhlo.HloProgram(
            collectives=ops, entry_params=(), unpaired_starts=0))
        assert hlo.collective_signature(canned_program()) == theirs

    def test_render_manifest_canonical(self, tmp_path):
        cap = make_capture(
            tmp_path, memory=hlo.MemoryStats(10, 10, "cpu"))
        manifest = hlo.build_manifest([cap])
        text = hlo.render_manifest(manifest)
        assert text.endswith("\n")
        assert json.loads(text) == manifest
        assert hlo.render_manifest(json.loads(text)) == text
        assert manifest["schema"] == hlo.HLO_MANIFEST_SCHEMA
        assert manifest["schema"] != jhlo.HLO_MANIFEST_SCHEMA
        sig = manifest["workloads"]["synthetic"]["signature"]
        assert sig["residentBytesPerDevice"] == 10
        assert sig["plan"] == {"axis": "dp", "numShards": 4, "entries": 0,
                               "shardedEntries": 0}
        assert manifest["workloads"]["synthetic"]["hash"] == (
            hlo.signature_hash(hlo.workload_signature(cap)))

    def test_diff_summary_is_the_jax_packages(self):
        from tf_operator_tpu.analysis.contract import diff_summary

        a = {"x": {"count": 1, "groupSizes": [4]}, "only_a": 1}
        b = {"x": {"count": 2, "groupSizes": [4]}, "only_b": 2}
        assert analysis.diff_summary(a, b) == diff_summary(a, b)
        assert analysis.diff_summary(a, a) == []

    def test_findings_json_has_the_jax_schema(self, tmp_path):
        findings = [analysis.Finding(rule=r, path="a.py", line=3,
                                     message="m") for r in hlo.HLO_RULES]
        ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
        analysis.write_findings_json(str(ours), findings, "hlo:lm")
        janalysis.write_findings_json(
            str(theirs), [janalysis.Finding(rule=f.rule, path=f.path,
                                            line=f.line, message=f.message)
                          for f in findings], "hlo:lm")
        got, want = json.loads(ours.read_text()), json.loads(
            theirs.read_text())
        # the same document but where each rule is documented
        for f in got["findings"]:
            assert f.pop("rule_doc") == analysis.rule_doc(f["rule"])
            assert f["severity"] == "error"
        for f in want["findings"]:
            f.pop("rule_doc")
        assert got == want
        assert [f.render() for f in findings][0] == (
            "a.py:3: [hlo-plan-drift] m")


def _tpus():
    yield TPUTopology(topology="2x2")
    for params in (10**6, 10**9, 7 * 10**9):
        for gb in (8.0, 16.0, 80.0):
            for mesh in ({"dp": 8}, {"dp": 2, "tp": 4},
                         {"dp": 4, "fsdp": 2}, {}):
                for zero in (False, True):
                    yield TPUTopology(
                        topology="2x4", mesh=mesh, device_memory_gb=gb,
                        model_params=params, zero_shard_weight_update=zero)


class TestAdmissionMath:
    @pytest.mark.parametrize("moments", [1, 2])
    def test_lower_bound_is_the_references(self, moments):
        for params in (0, 1, 1000, 124_439_808, 10**9 + 7):
            for dp in (1, 2, 8):
                for mp in (1, 2, 4):
                    for zero in (False, True):
                        kw = dict(dp_shards=dp, model_parallel=mp,
                                  zero=zero, moments_per_param=moments)
                        assert hlo.admission_peak_lower_bound(
                            params, **kw) == \
                            jhlo.admission_peak_lower_bound(params, **kw)

    def test_lower_bound_zero_divides_moments(self):
        dense = hlo.admission_peak_lower_bound(1000, dp_shards=4)
        sharded = hlo.admission_peak_lower_bound(
            1000, dp_shards=4, zero=True)
        assert dense == 1000 * 4 + 1000 * 4 + 1000 * 4 * 2
        assert sharded == 1000 * 4 + 1000 * 4 + 1000 * 4 * 2 // 4

    def test_memory_check_is_the_references(self):
        tpus = list(_tpus())
        reasons = [hlo.admission_memory_check(t) for t in tpus]
        assert reasons == [jhlo.admission_memory_check(t) for t in tpus]
        assert hlo.admission_memory_check(None) is None
        # both outcomes occur on the grid, the hint among the reasons
        assert None in reasons
        assert any(r and "zeroShardWeightUpdate" in r for r in reasons)


def test_with_overlap_json_is_the_jax_plans():
    """`with_overlap()` on the port's plan of the tiny LM over {"dp": 4}
    prints JAX's `with_overlap()` byte for byte: every dim-sharded entry
    marked, the others not."""
    cfg = dict(vocab_size=128, num_layers=2, num_heads=2, d_model=32,
               d_ff=64, max_len=16)
    with torch.device("meta"):
        port = T.TransformerLM(T.TransformerConfig(**cfg))
    shapes = jax.eval_shape(lambda: J.TransformerLM(J.TransformerConfig(
        **cfg)).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    )["params"]
    for axes in ({"dp": 4}, {"dp": 2, "tp": 2}):
        n = 4
        jmesh = j_build_mesh(axes, devices=jax.devices()[:n])
        jplan = jzero.build_zero_plan(
            shapes, jmesh, base_specs=make_param_shardings(shapes, jmesh))
        plan = tzero.plan_for_model(port, build_mesh(axes, n))
        assert plan.with_overlap().to_json() == \
            jplan.with_overlap().to_json()
        marked = [e for e in plan.with_overlap().entries if e.overlap]
        assert len(marked) == sum(e.dim is not None for e in plan.entries)
        assert plan.with_overlap().with_overlap() == plan.with_overlap()
    assert len(flax_param_map(port)) == len(plan.entries)


def test_flax_dims_reads_every_layout():
    """A query weight [H * D, d] and an out weight [d, H * D], whole, as a
    ZeRO slice on d or heads, and on the view that splits heads from
    head_dim, read back onto flax's (d, H, D) and (H, D, d)."""
    with torch.device("meta"):
        port = T.TransformerLM(T.TransformerConfig(
            vocab_size=128, num_layers=1, num_heads=2, d_model=32, d_ff=64,
            max_len=16))
    fmap = {e.name: e for e in flax_param_map(port)}
    q, out = fmap["blocks.0.attn.query.weight"], fmap["blocks.0.attn.out.weight"]
    assert hlo.flax_dims(q, (32, 32)) == (32, 2, 16)
    assert hlo.flax_dims(q, (32, 8)) == (8, 2, 16)      # d sliced
    assert hlo.flax_dims(q, (16, 32)) == (32, 1, 16)    # heads sliced
    assert hlo.flax_dims(q, (2, 4, 32)) == (32, 2, 4)   # head_dim, on the view
    assert hlo.flax_dims(out, (32, 32)) == (2, 16, 32)
    assert hlo.flax_dims(out, (32, 2, 4)) == (2, 4, 32)
    assert hlo.flax_dims(out, (8, 32)) == (2, 16, 8)
    assert hlo.flax_dims(fmap["wte.weight"], (32, 32)) == (32, 32)
    assert hlo.flax_dims(fmap["blocks.0.mlp.wi.weight"], (64, 8)) == (8, 64)
    assert hlo.flax_dims(q, ()) == ()


def test_same_inventory_raises_on_a_diverging_rank():
    a = [("all-reduce", (("f32", (4,)),), (("f32", (4,)),), 4)]
    b = a + [("broadcast", (("f32", (1,)),), (("f32", (1,)),), 4)]
    hlo.same_inventory([a, a, a])
    with pytest.raises(RuntimeError, match=r"rank 2 issued 2 .* rank 0 1"):
        hlo.same_inventory([a, a, b])
    c = [("all-reduce", (("f32", (5,)),), (("f32", (5,)),), 4)]
    with pytest.raises(RuntimeError, match="part at #0"):
        hlo.same_inventory([a, c])


def test_main_module_runs_nothing_at_import():
    import importlib

    module = importlib.import_module("tf_operator_tpu_torch.analysis.__main__")
    assert callable(module.main)
    with pytest.raises(SystemExit):
        module.main(["--hlo", "lm", "--manifest"])  # needs --json
    with pytest.raises(SystemExit, match="unknown rule"):
        module.main(["--hlo", "lm", "--rules", "hlo-nope"])


def test_recorder_restores_the_entry_points():
    """The recorder wraps torch.distributed's and c10d's names while it is
    active and restores both on exit, on an error too; a second recorder
    inside the first refuses to start and leaves the first's wrappers."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    names = list(hlo._ENTRY_POINTS)
    before = [getattr(dist, n) for n in names]
    with pytest.raises(ZeroDivisionError):
        with hlo.CollectiveRecorder():
            assert dist.all_reduce is not before[0]
            assert c10d.isend is dist.isend is not before[names.index("isend")]
            1 / 0
    assert [getattr(dist, n) for n in names] == before
    assert [getattr(c10d, n) for n in names] == before
    with hlo.CollectiveRecorder() as rec:
        wrapped = dist.all_reduce
        with pytest.raises(RuntimeError, match="already recording"):
            hlo.CollectiveRecorder().__enter__()
        assert dist.all_reduce is wrapped
    assert rec.ops == [] and rec.unpaired_starts == 0
    assert [getattr(dist, n) for n in names] == before
