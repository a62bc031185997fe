"""Typed image manifests in the port against the reference: schema
unification, the command grammar, plan-time type checks and capacity
inference, monoid resolution and mount wiring
(``repro_torch.core.{schema,manifests,images,mounts}``).

The cases are the reference's ``tests/test_manifests.py``, each run
through both packages on the same inputs: what it pins holds for both,
and the outputs (arrays, ``describe()`` strings, error messages) are
equal.  All 30 cases are here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.container import ContainerOp as RContainerOp
from repro.core.images import fn_image as r_fn_image
from repro.core.schema import substitute as r_substitute
from repro.core.schema import unify as r_unify
from repro.io.formats import FORMATS as R_FORMATS
from repro.io.formats import pack_records as r_pack
from repro_torch.core.container import ContainerOp as TContainerOp
from repro_torch.core.images import fn_image as t_fn_image
from repro_torch.core.schema import substitute as t_substitute
from repro_torch.core.schema import unify as t_unify
from repro_torch.io.formats import FORMATS as T_FORMATS
from repro_torch.io.formats import pack_records as t_pack

PKGS = {
    R: dict(unify=r_unify, substitute=r_substitute, formats=R_FORMATS,
            pack=r_pack, op=RContainerOp, fn_image=r_fn_image,
            i32=jnp.int32, f32=jnp.float32,
            f64=jnp.float64, arr=jnp.asarray, kw={}),
    T: dict(unify=t_unify, substitute=t_substitute, formats=T_FORMATS,
            pack=t_pack, op=TContainerOp, fn_image=t_fn_image,
            i32=torch.int32,
            f32=torch.float32, f64=torch.float64, arr=torch.as_tensor,
            kw={"device": "cpu"}),
}


def both(case):
    """case(mod, pkg) for the reference, then the port; returns both."""
    return case(R, PKGS[R]), case(T, PKGS[T])


def mare(mod, pkg, data, **kw):
    return mod.MaRe(data, **pkg["kw"], **kw)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(
        tree, is_leaf=torch.is_tensor)]


def same_leaves(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype, (x.dtype, y.dtype)
        np.testing.assert_array_equal(y, x)


def same_up_to_contract_dtype(ref, port, dtype):
    """A mount check's messages agree but in how the contract's dtype is
    printed: the reference prints the jnp scalar type's repr ("<class
    'jax.numpy.int32'>"), the port its name ("int32"); ROADMAP Queue 3
    lists the difference."""
    head = " != contract "
    assert ref.split(head)[0] == port.split(head)[0]
    assert port.split(head)[1] == dtype
    assert ref.split(head)[1] == f"<class 'jax.numpy.{dtype}'>"


def message(mod, exc, fn):
    with pytest.raises(exc) as e:
        fn()
    return str(e.value)


# -- schema primitives --------------------------------------------------------

def test_schema_of_records_and_describe():
    def case(mod, pkg):
        recs = {"data": np.zeros((4, 70), np.uint8),
                "len": np.zeros((4,), np.int32)}
        s = mod.schema_of_records(recs)
        assert s.concrete
        return (s.describe(),
                mod.schema_of_records((np.zeros((3,), np.int32),)
                                      ).describe())
    ref, port = both(case)
    assert ref == port == ("{data: u8[70], len: i32}", "(i32)")


def test_unify_binds_symbolic_dims():
    def case(mod, pkg):
        declared = mod.bytes_record_schema()
        actual = mod.schema_of_records({"data": np.zeros((4, 70), np.uint8),
                                        "len": np.zeros((4,), np.int32)})
        env = pkg["unify"](declared, actual)
        return env["W"], pkg["substitute"](declared, env).describe()
    ref, port = both(case)
    assert ref == port == (70, "{data: u8[70], len: i32}")


def test_unify_mismatches_raise_with_leaf_path():
    def case(mod, pkg):
        declared = mod.bytes_record_schema()
        wrong_dtype = mod.schema_of_records(
            {"data": np.zeros((4, 70), np.int32),
             "len": np.zeros((4,), np.int32)})
        wrong_structure = mod.schema_of_records((np.zeros((4,), np.int32),))
        return (message(mod, mod.SchemaMismatch,
                        lambda: pkg["unify"](declared, wrong_dtype)),
                message(mod, mod.SchemaMismatch,
                        lambda: pkg["unify"](declared, wrong_structure)))
    ref, port = both(case)
    assert "dtype" in port[0] and "structure" in port[1]
    assert ref == port


def test_format_schema_matches_packed_records():
    def case(mod, pkg):
        packed = pkg["pack"]([b"ACGT", b"GG"], capacity=4)
        return {name: pkg["unify"](fmt.schema,
                                   mod.schema_of_records(packed))["W"]
                for name, fmt in pkg["formats"].items()}
    ref, port = both(case)
    assert ref == port and set(port.values()) == {4}


# -- command grammar (pull-time) ----------------------------------------------

def test_grammar_unknown_command_and_missing_arg():
    def case(mod, pkg):
        return (message(mod, ValueError,
                        lambda: mod.pull("ubuntu", command="grep-lines GC")),
                message(mod, ValueError,
                        lambda: mod.pull("ubuntu", command="grep-chars")),
                message(mod, ValueError, lambda: mod.pull("ubuntu")))
    ref, port = both(case)
    assert "unknown command 'grep-lines'" in port[0]
    assert "missing required argument" in port[1]
    assert "requires a command; grammar" in port[2]
    assert ref == port


def test_grammar_typed_args_and_dispatch():
    def case(mod, pkg):
        op = mod.pull("ubuntu", command="grep-count 2 3")
        errs = (message(mod, ValueError,
                        lambda: mod.pull("ubuntu", command="grep-count two")),
                message(mod, ValueError,
                        lambda: mod.pull("ubuntu", command="awk-sum extra")))
        awk = mod.pull("ubuntu", command="awk-sum")
        return (op.params["codes"], errs, awk.associative_commutative,
                awk.contract.monoid,
                mod.pull("kmer-stats", command="kmer-stats 4").params["k"])
    ref, port = both(case)
    assert port[0] == (2, 3)
    assert "bad argument for 'codes'" in port[1][0]
    assert "unexpected arguments" in port[1][1]
    assert port[2:] == (True, "sum", 4)
    assert ref == port


def test_command_argv_overrides_python_kwargs():
    def case(mod, pkg):
        return mod.pull("kmer-stats", command="kmer-stats 5", k=9
                        ).params["k"]
    assert both(case) == (5, 5)


# -- plan-time type checking --------------------------------------------------

def test_mistyped_pipeline_fails_at_build_not_trace():
    def case(mod, pkg):
        cache = mod.PlanCache()
        m = mare(mod, pkg, (np.arange(16, dtype=np.int32),),
                 plan_cache=cache).map(image="ubuntu",
                                       command="grep-count 2 3")
        msg = message(mod, mod.PlanTypeError, lambda: m.map(
            image="ubuntu", command="grep-chars GC"))
        assert cache.stats()["misses"] == 0      # nothing was compiled
        return msg
    ref, port = both(case)
    assert "stage 0" in port and "{data: u8[W], len: i32}" in port
    assert "(i32)" in port and "grep-chars" in port and "grep-count" in port
    assert ref == port


def test_reduce_by_key_num_keys_below_declared_key_space():
    def case(mod, pkg):
        packed = pkg["pack"]([b"ACGTACGT", b"GGGGCCCC"], capacity=4)
        m = mare(mod, pkg, packed, plan_cache=mod.PlanCache()).map(
            image="kmer-stats", k=3)
        return message(mod, mod.PlanTypeError, lambda: m.reduce_by_key(
            lambda r: r[0], value_by=lambda r: (r[1],), op="sum",
            num_keys=10))
    ref, port = both(case)
    assert "num_keys=10 is smaller" in port and ref == port


def test_reduce_by_key_num_keys_inferred_from_manifest():
    def case(mod, pkg):
        packed = pkg["pack"]([b"ACGTACGT", b"GGGGCCCC"], capacity=4)
        m = (mare(mod, pkg, packed, plan_cache=mod.PlanCache())
             .map(image="kmer-stats", k=3)
             .reduce_by_key(lambda r: r[0], value_by=lambda r: (r[1],),
                            op="sum"))
        assert m.plan.stages[-1].num_keys == 4 ** 3
        keys, (occ,), cnt = m.collect()
        assert int(occ.sum()) == 2 * (8 - 3 + 1)
        return keys, occ, cnt
    same_leaves(*both(case))


def test_key_space_bound_skipped_when_key_by_remaps():
    def case(mod, pkg):
        packed = pkg["pack"]([b"ACGTACGT", b"GGGGCCCC"], capacity=4)
        m = (mare(mod, pkg, packed, plan_cache=mod.PlanCache())
             .map(image="kmer-stats", k=3)
             .reduce_by_key(lambda r: r[0] % 16, value_by=lambda r: (r[1],),
                            op="sum", num_keys=16))
        keys, (occ,), cnt = m.collect()
        assert int(occ.sum()) == 2 * (8 - 3 + 1)
        assert all(0 <= int(k) < 16 for k in keys)
        return keys, occ, cnt
    same_leaves(*both(case))


def test_key_space_bound_skipped_when_keyed_on_other_leaf():
    def case(mod, pkg):
        packed = pkg["pack"]([b"ACGTACGT"], capacity=2)
        m = (mare(mod, pkg, packed, plan_cache=mod.PlanCache())
             .map(image="kmer-stats", k=2)
             .reduce_by_key(lambda r: r[1], value_by=lambda r: (r[1],),
                            op="sum", num_keys=2))
        keys, (s,), cnt = m.collect()
        assert set(int(k) for k in keys) <= {0, 1}
        return keys, s, cnt
    same_leaves(*both(case))


def test_single_leaf_schema_accepts_bare_array_records():
    def case(mod, pkg):
        dna = np.array([2, 3, 0, 1, 2], np.int32)
        m = mare(mod, pkg, dna, plan_cache=mod.PlanCache()).map(
            image="ubuntu", command="grep-count 2 3")
        return int(np.asarray(leaves(m.collect())[0]).sum())
    assert both(case) == (3, 3)


def test_optional_variadic_absent_preserves_kwargs():
    def case(mod, pkg):
        return mod.pull("ubuntu", command="grep-count", codes=(2, 3)
                        ).params["codes"]
    assert both(case) == ((2, 3), (2, 3))


def test_reduce_by_key_num_keys_required_without_key_space():
    def case(mod, pkg):
        keys = np.arange(8, dtype=np.int32)
        return message(mod, ValueError, lambda: mare(
            mod, pkg, (keys,)).reduce_by_key(lambda r: r[0], op="sum"))
    ref, port = both(case)
    assert "num_keys not given" in port and ref == port


def test_key_by_type_checked_at_build():
    def case(mod, pkg):
        vals = np.linspace(0, 1, 16, dtype=np.float32)
        return (message(mod, mod.PlanTypeError, lambda: mare(
                    mod, pkg, (vals,)).reduce_by_key(
                        lambda r: r[0], op="sum", num_keys=4)),
                message(mod, mod.PlanTypeError, lambda: mare(
                    mod, pkg, (vals,)).repartition_by(lambda r: r[0])))
    ref, port = both(case)
    assert all("key_by must return one int" in m for m in port)
    # the message's tail quotes each framework's own shape-inference error
    assert [m.split(":")[0] for m in ref] == [m.split(":")[0] for m in port]


def test_capacity_transfer_inferred_in_describe():
    def case(mod, pkg):
        packed = pkg["pack"]([b"ACGTACGT"] * 3, capacity=8, width=8)
        m = mare(mod, pkg, packed, plan_cache=mod.PlanCache()).map(
            image="kmer-stats", k=3)
        cap = m._dataset.capacity
        d = m.describe()
        assert f"(i32, i32)#{cap * 6}" in d
        assert "{data: u8[8], len: i32}" in d
        return d
    ref, port = both(case)
    assert ref == port


def test_capacity_transfer_failure_names_stage():
    def case(mod, pkg):
        packed = pkg["pack"]([b"ACG"] * 8, capacity=8, width=3)
        return message(mod, mod.PlanTypeError, lambda: mare(
            mod, pkg, packed).map(image="kmer-stats", k=8))
    ref, port = both(case)
    assert "stage 0" in port and "capacity transfer" in port
    assert ref == port


def test_monoid_resolution_via_manifest_sum_image():
    def case(mod, pkg):
        keys = np.array([0, 1, 0, 1], np.int32)
        vals = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
        m = mare(mod, pkg, (keys, vals), plan_cache=mod.PlanCache()
                 ).reduce_by_key(lambda r: r[0], value_by=lambda r: (r[1],),
                                 image="toolbox/sum", num_keys=2)
        assert m.plan.stages[-1].op == "sum"
        out = m.collect()
        out_keys, (out_sum,), _ = out
        assert {int(k): float(s) for k, s in zip(out_keys, out_sum)} == {
            0: 4.0, 1: 6.0}
        return out
    same_leaves(*both(case))


# -- mount wiring (plan-time + execution-time) --------------------------------

def test_mount_contract_checked_at_plan_time():
    def case(mod, pkg):
        cache = mod.PlanCache()
        m = mare(mod, pkg, (np.arange(8, dtype=np.float32),),
                 plan_cache=cache)
        msg = message(mod, mod.PlanTypeError, lambda: m.map(
            image="toolbox/concat",
            input_mount=mod.TextFile("/x", dtype=pkg["i32"])))
        assert cache.stats()["misses"] == 0
        return msg
    ref, port = both(case)
    assert "stage 0" in port and "input mount" in port and ref == port


def test_mount_validation_fires_at_execution_with_stage_and_image():
    """Ops without manifests leave the schema unknown, so the mount check
    falls through to stage execution -- and must name stage + image."""
    def case(mod, pkg):
        def to_float(part, **kw):
            leaf = jax.tree.leaves(part.records, is_leaf=torch.is_tensor)[0]
            return mod.make_partition((leaf.astype(jnp.float32)
                                       if mod is R else leaf.float(),),
                                      part.count)

        op1 = pkg["op"](image="anon/to-float", fn=to_float)
        op2 = pkg["op"](image="anon/wants-int", fn=lambda part, **kw: part,
                        input_mount=mod.RecordMount("/x", dtype=pkg["i32"]))
        m = (mare(mod, pkg, (np.arange(8, dtype=np.int32),),
                  plan_cache=mod.PlanCache()).map(op=op1).map(op=op2))
        return message(mod, ValueError, m.collect)
    ref, port = both(case)
    assert "stage 0" in port and "anon/wants-int" in port
    assert "float32" in port
    same_up_to_contract_dtype(ref, port, "int32")


def test_reduce_mount_validation_fires_with_stage_and_image():
    def case(mod, pkg):
        def passthrough(part, **kw):
            return part

        hide = pkg["op"](image="anon/hide", fn=passthrough)
        red = pkg["op"](image="anon/reduce", fn=passthrough,
                        associative_commutative=True,
                        input_mount=mod.RecordMount("/r", dtype=pkg["f64"]))
        m = (mare(mod, pkg, (np.arange(8, dtype=np.int32),),
                  plan_cache=mod.PlanCache()).map(op=hide).reduce(op=red))
        return message(mod, ValueError, m.collect)
    ref, port = both(case)
    assert "stage 1" in port and "anon/reduce" in port
    same_up_to_contract_dtype(ref, port, "float64")


def test_shuffle_capacity_inference_matches_materialized():
    def case(mod, pkg):
        m = (mare(mod, pkg, (np.arange(32, dtype=np.int32),),
                  plan_cache=mod.PlanCache())
             .map(image="toolbox/concat")
             .repartition_by(lambda r: r[0] % 3))
        inferred = m._stage_states()[-1].capacity
        assert inferred == m.dataset.capacity
        m2 = (mare(mod, pkg, (np.arange(32, dtype=np.int32),),
                   plan_cache=mod.PlanCache())
              .repartition_by(lambda r: r[0] % 3, capacity=16))
        return inferred, m2._stage_states()[-1].capacity
    ref, port = both(case)
    assert port[1] == 16 and ref == port


def test_topk_image_handles_integer_scores():
    def case(mod, pkg):
        op = mod.pull("toolbox/topk", k=2)
        part = mod.make_partition(
            (pkg["arr"](np.asarray([5, 9, 1, 7], np.int32)),), 3)
        out = op(part)
        return sorted(np.asarray(out.records[0])[:2].tolist())
    assert both(case) == ([5, 9], [5, 9])


# -- grammar spec building ----------------------------------------------------

def test_variadic_required_argument_enforced():
    def case(mod, pkg):
        manifest = mod.ImageManifest(commands=(
            mod.CommandSpec("need-args",
                            args=(mod.ArgSpec("xs", type=int,
                                              variadic=True),)),))
        msg = message(mod, ValueError, lambda: manifest.parse_command(
            "need-args", image="anon/v"))
        _, params = manifest.parse_command("need-args 1 2", image="anon/v")
        return msg, params
    ref, port = both(case)
    assert "missing required argument 'xs'" in port[0]
    assert port[1] == {"xs": (1, 2)} and ref == port


def test_custom_manifest_grammar_roundtrip():
    def case(mod, pkg):
        manifest = mod.ImageManifest(commands=(
            mod.CommandSpec("tool", args=(
                mod.ArgSpec("n", type=int),
                mod.ArgSpec("names", required=False, variadic=True))),))
        spec, params = manifest.parse_command("tool 3 a b", image="anon/t")
        _, params2 = manifest.parse_command("tool 3", image="anon/t")
        return spec.name, params, params2
    ref, port = both(case)
    assert port == ("tool", {"n": 3, "names": ("a", "b")}, {"n": 3})
    assert ref == port


# -- fn_image: runtime-built images -------------------------------------------

def _arange4(pkg):
    return pkg["arr"](np.arange(4, dtype=np.int32))


def test_fn_image_with_grammarless_manifest_forwards_command():
    def case(mod, pkg):
        seen = {}

        def tool(part, command="", **kw):
            seen["command"] = command
            return part

        reg = mod.Registry()
        pkg["fn_image"]("anon/manifested-cmd", tool, registry=reg,
                        manifest=mod.ImageManifest(output_schema=mod.SAME))
        op = reg.pull("anon/manifested-cmd", command="--flag x")
        op(mod.make_partition((_arange4(pkg),), 4))
        return seen["command"]
    assert both(case) == ("--flag x", "--flag x")


def test_fn_image_forwards_command_string():
    def case(mod, pkg):
        seen = {}

        def tool(part, command="", **kw):
            seen["command"] = command
            return part

        reg = mod.Registry()
        pkg["fn_image"]("anon/cmd-tool", tool, registry=reg)
        op = reg.pull("anon/cmd-tool", command="frobnicate --fast")
        op(mod.make_partition((_arange4(pkg),), 4))
        return seen["command"], op.name, sorted(reg.images())
    ref, port = both(case)
    assert port[0] == "frobnicate --fast"
    assert ref == port


def test_fn_image_without_command_param_still_works():
    def case(mod, pkg):
        def plain(part):
            return part

        reg = mod.Registry()
        pkg["fn_image"]("anon/plain-tool", plain, registry=reg)
        out = reg.pull("anon/plain-tool")(
            mod.make_partition((_arange4(pkg),), 4))
        return out.capacity, leaves(out.records)[0].tolist()
    assert both(case) == ((4, [0, 1, 2, 3]), (4, [0, 1, 2, 3]))


def test_fn_image_with_manifest_participates_in_inference():
    def case(mod, pkg):
        def doubler(part, **kw):
            (x,) = part.records
            return mod.make_partition((x * 2,), part.count)

        reg = mod.Registry()
        pkg["fn_image"]("anon/doubler", doubler, registry=reg,
                        manifest=mod.ImageManifest(
                            input_schema=mod.Schema((mod.field(pkg["i32"]),)),
                            output_schema=mod.SAME))
        m = mare(mod, pkg, (np.arange(8, dtype=np.int32),), registry=reg,
                 plan_cache=mod.PlanCache()).map(image="anon/doubler")
        msg = message(mod, mod.PlanTypeError, lambda: mare(
            mod, pkg, (np.arange(8, dtype=np.float32),), registry=reg,
            plan_cache=mod.PlanCache()).map(image="anon/doubler"))
        return m.describe(), msg, leaves(m.collect())[0].tolist()
    ref, port = both(case)
    assert "(i32)" in port[0]
    assert "input schema mismatch" in port[1]
    assert port[2] == [2 * i for i in range(8)]
    assert ref == port
