"""The port's deprecated-shim contract against the reference's: every
legacy spelling warns EXACTLY once per process, forwards its arguments
unchanged, and gives what the canonical spelling gives.

The cases are the reference's ``tests/test_deprecations.py``, each run
through both packages: the warnings' messages, the forwarded arguments
and the results are compared.  Each package has its own warning category
and its own warn-once state.
"""
import warnings

import numpy as np
import pytest

import repro.core as R
import repro.deprecations as RDep
import repro_torch.core as T
import repro_torch.deprecations as TDep
from repro.core.container import ContainerOp as RContainerOp
from repro.core.mare import MaRe as RMaRe
from repro.core.mare import PAPER_KWARG_ALIASES as R_KWARGS
from repro.core.mare import PAPER_METHOD_ALIASES as R_METHODS
from repro_torch.core.container import ContainerOp as TContainerOp
from repro_torch.core.mare import MaRe as TMaRe
from repro_torch.core.mare import PAPER_KWARG_ALIASES as T_KWARGS
from repro_torch.core.mare import PAPER_METHOD_ALIASES as T_METHODS

pytestmark = [
    pytest.mark.filterwarnings(
        "always::repro.deprecations.MaReDeprecationWarning"),
    pytest.mark.filterwarnings(
        "always::repro_torch.deprecations.MaReDeprecationWarning"),
]

PKGS = {
    R: dict(dep=RDep, mare=RMaRe, op=RContainerOp, kw={},
            methods=R_METHODS, kwargs=R_KWARGS),
    T: dict(dep=TDep, mare=TMaRe, op=TContainerOp, kw={"device": "cpu"},
            methods=T_METHODS, kwargs=T_KWARGS),
}


def both(case):
    """case(mod, pkg) for the reference, then the port; returns both."""
    return case(R, PKGS[R]), case(T, PKGS[T])


@pytest.fixture(autouse=True)
def _fresh_warn_once():
    # warn-once state is process-global; each test starts clean
    RDep.reset()
    TDep.reset()
    yield
    RDep.reset()
    TDep.reset()


def _m(mod, pkg, n=32):
    return mod.MaRe((np.arange(n, dtype=np.int32),),
                    plan_cache=mod.PlanCache(), **pkg["kw"])


def _ident_op(pkg):
    return pkg["op"](image="dep/id", fn=lambda part, **kw: part)


def _warns(pkg, match=None):
    return pytest.warns(pkg["dep"].MaReDeprecationWarning, match=match)


def test_category_is_a_deprecation_warning():
    def case(mod, pkg):
        return issubclass(pkg["dep"].MaReDeprecationWarning,
                          DeprecationWarning)
    assert both(case) == (True, True)


def test_warn_once_is_per_key_not_per_call():
    def case(mod, pkg):
        cat = pkg["dep"].MaReDeprecationWarning
        with _warns(pkg) as first:
            _m(mod, pkg).collect_first_shard()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _m(mod, pkg).collect_first_shard()      # second call: silent
            with _warns(pkg) as other:
                _m(mod, pkg).collect_async().result(timeout=60)
        assert not [w for w in caught if issubclass(w.category, cat)]
        return ([str(w.message) for w in first],
                [str(w.message) for w in other])
    ref, port = both(case)
    assert ref == port


# -- action shims forward exactly --------------------------------------------

def _forwarding(monkeypatch, pkg, seen):
    monkeypatch.setattr(pkg["mare"], "collect",
                        lambda self, **kw: seen.update(kw) or "value")


@pytest.mark.parametrize("shim,args,forwarded", [
    ("collect_async", {"label": "x"}, {"asynchronous": True, "label": "x"}),
    ("collect_first_shard", {}, {"shard": 0}),
    ("collect_first_shard_async", {"label": "w3"},
     {"shard": 0, "asynchronous": True, "label": "w3"}),
], ids=["test_collect_async_forwards", "test_collect_first_shard_forwards",
        "test_collect_first_shard_async_forwards"])
def test_action_shim_forwards(monkeypatch, shim, args, forwarded):
    def case(mod, pkg):
        seen = {}
        _forwarding(monkeypatch, pkg, seen)
        with _warns(pkg, match=shim) as rec:
            assert getattr(_m(mod, pkg), shim)(**args) == "value"
        return seen, [str(w.message) for w in rec]
    ref, port = both(case)
    assert port[0] == forwarded
    assert ref == port


def test_collect_shims_equal_canonical_results():
    def case(mod, pkg):
        data = (np.arange(8, dtype=np.int32),)
        with _warns(pkg):
            legacy = mod.MaRe(data, plan_cache=mod.PlanCache(),
                              **pkg["kw"]).collect_first_shard()
        canonical = mod.MaRe(data, plan_cache=mod.PlanCache(),
                             **pkg["kw"]).collect(shard=0)
        assert legacy[0].tolist() == canonical[0].tolist()
        return legacy[0].tolist()
    ref, port = both(case)
    assert ref == port


# -- last_diagnostics shim ----------------------------------------------------

def test_last_diagnostics_is_view_over_newest_report():
    def case(mod, pkg):
        m = _m(mod, pkg).map(op=_ident_op(pkg))
        m.collect()
        with _warns(pkg, match="last_diagnostics") as rec:
            assert m.last_diagnostics == m.report().diagnostics
        fresh = _m(mod, pkg)
        pkg["dep"].reset()
        with _warns(pkg):
            assert fresh.last_diagnostics == {}   # no action yet -> empty
        return [str(w.message) for w in rec]
    ref, port = both(case)
    assert ref == port


# -- paper-spelling aliases ---------------------------------------------------

def test_method_alias_table_is_applied_and_forwards(monkeypatch):
    key = lambda recs: recs[0]  # noqa: E731

    def case(mod, pkg):
        calls = {}
        monkeypatch.setattr(
            pkg["mare"], "repartition_by",
            lambda self, *a, **kw: calls.update(args=a, kwargs=kw) or "rb")
        with _warns(pkg, match="repartitionBy") as rec:
            assert _m(mod, pkg).repartitionBy(key, capacity=7) == "rb"
        return pkg["methods"], calls, [str(w.message) for w in rec]
    ref, port = both(case)
    assert port[0] == {"repartitionBy": "repartition_by",
                       "reduceByKey": "reduce_by_key"}
    assert port[1] == {"args": (key,), "kwargs": {"capacity": 7}}
    assert ref == port


def test_reduce_by_key_alias_forwards_all_kwargs(monkeypatch):
    key = lambda recs: recs[0]  # noqa: E731

    def case(mod, pkg):
        calls = {}
        monkeypatch.setattr(
            pkg["mare"], "reduce_by_key",
            lambda self, *a, **kw: calls.update(args=a, kwargs=kw) or "rbk")
        with _warns(pkg, match="reduceByKey"):
            assert _m(mod, pkg).reduceByKey(key, num_keys=3,
                                            op="max") == "rbk"
        return calls
    ref, port = both(case)
    assert port == {"args": (key,), "kwargs": {"num_keys": 3, "op": "max"}}
    assert ref == port


def test_mount_kwarg_aliases_translate():
    def case(mod, pkg):
        with _warns(pkg, match="inputMountPoint"):
            legacy = _m(mod, pkg).map(
                inputMountPoint=mod.TextFile("/x", dtype=np.int32),
                outputMountPoint=mod.TextFile("/y"),
                image="ubuntu", command="grep-count 1 2")
        canonical = _m(mod, pkg).map(
            input_mount=mod.TextFile("/x", dtype=np.int32),
            output_mount=mod.TextFile("/y"),
            image="ubuntu", command="grep-count 1 2")
        assert legacy.describe() == canonical.describe()
        return pkg["kwargs"], legacy.describe()
    ref, port = both(case)
    assert port[0] == {"inputMountPoint": "input_mount",
                       "outputMountPoint": "output_mount"}
    assert ref == port


def test_both_alias_and_canonical_kwarg_is_an_error():
    def case(mod, pkg):
        with pytest.raises(TypeError, match="both") as e:
            _m(mod, pkg).map(inputMountPoint=mod.TextFile("/x"),
                             input_mount=mod.TextFile("/x"),
                             image="ubuntu", command="grep-chars GC")
        return str(e.value)
    ref, port = both(case)
    assert ref == port
