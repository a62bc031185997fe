"""The port's dry run (``repro_torch/launch/dryrun{,_lib}.py``): each
cell's step counted on the meta device.

* the reference's ``tests/distributed/dryrun_small.py`` on the port: six
  families' reduced configs on a (2, 4) mesh, train and decode;
* both packages' total FLOPs for the smoke configs on a one-device mesh.
  The reference walks XLA's module after fusion and algebraic
  simplification, the port counts every eager op: for the dense and the
  xLSTM families the two agree within 5% (0.966-0.998 measured at these
  shapes).  The other families are left out because the two compute them
  differently: the reference's ``ragged_dot`` multiplies every row by
  every expert on the CPU backend (its own note,
  ``src/repro/models/moe.py:172-174``; the port's ratio is k / E), and
  its hybrid and audio steps run XLA's scan and attention where the port
  counts its kernels' formulas;
* the port's exact matmul FLOPs for Llama's smoke step against an
  analytic count;
* a counter that counts loops once (two bodies counted for all) against
  the stepwise count: equal for a forward, and for a gradient equal in
  its matmuls and a lower bound otherwise (what autograd does outside the
  bodies for the ones not run: views' backward, the adds of their
  gradients into what they share);
* the planner's ``prog.cost`` with tracing on and off; the CLI.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.obs as TO
import repro_torch.runtime as TR
from repro import compat
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.shapes import ShapeConfig as RefShape
from repro.launch.dryrun_lib import dry_run_cell as ref_dry_run_cell
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.core.container import ContainerOp
from repro_torch.kernels.work import (BF16_FLOP_PER_S, HBM_BYTES_PER_S,
                                      LINK_BYTES_PER_S)
from repro_torch.launch import dryrun, hlo_cost
from repro_torch.launch.dryrun_lib import (argument_bytes, cell_config,
                                           cell_step, choose_optimizer,
                                           dry_run_cell, rules_for)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, param_count
from repro_torch.train.step import StepConfig

TINY_TRAIN = ShapeConfig("tiny_train", "train", 32, 8)
TINY_PREFILL = ShapeConfig("tiny_prefill", "prefill", 32, 8)
TINY_DECODE = ShapeConfig("tiny_dec", "decode", 64, 8)
FAMILIES = ("smollm-135m", "granite-moe-1b-a400m", "hymba-1.5b",
            "xlstm-1.3b", "whisper-base", "internvl2-1b")


@pytest.fixture(scope="module")
def mesh24():
    return make_mesh((2, 4), ("data", "model"))


@pytest.mark.parametrize("arch", FAMILIES)
def test_dryrun_small_families(arch, mesh24):
    """``tests/distributed/dryrun_small.py`` on the port."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    r = dry_run_cell(cfg, TINY_TRAIN, mesh24, extract_collectives=False)
    assert r["flops"] > 0 and r["global_flops"] == r["flops"] * 8
    assert r["optimizer"] == "adamw" and r["collectives"] == {}
    r2 = dry_run_cell(cfg, TINY_DECODE, mesh24, extract_collectives=False)
    assert r2["flops"] > 0 and r2["optimizer"] is None


def test_cell_terms_and_policies(mesh24):
    """The roofline terms over the H100's rates, memory, and the
    reference's per-cell policies: token_gather for MoE decode (its
    all-to-alls reported), ssm_cp for a hybrid prefill whose batch does
    not divide the mesh, no collective in a fused dense step."""
    dense = dry_run_cell(get_smoke_config("llama3.2-1b"), TINY_TRAIN,
                         mesh24)
    assert dense["compute_s"] == dense["flops"] / BF16_FLOP_PER_S
    assert dense["memory_s"] == dense["bytes"] / HBM_BYTES_PER_S
    assert dense["collectives"] is None and dense["collective_s"] is None
    assert dense["memory"]["peak_bytes"] > \
        dense["memory"]["argument_bytes"] > 0
    assert dense["torch_flops"] > 0 and dense["lower_s"] >= 0
    moe = dry_run_cell(get_smoke_config("granite-moe-1b-a400m"),
                       TINY_DECODE, mesh24)
    assert moe["moe_mode"] == "token_gather"
    assert moe["collectives"]["counts"]["all-to-all"] > 0
    assert moe["collective_s"] == \
        moe["collectives"]["wire_bytes"] / LINK_BYTES_PER_S
    hybrid = dry_run_cell(get_smoke_config("hymba-1.5b"),
                          ShapeConfig("p", "prefill", 32, 4), mesh24)
    assert hybrid["ssm_cp"] is True
    assert hybrid["collectives"]["counts"]["collective-permute"] > 0
    assert hybrid["kernels"]["ssm_scan"]["calls"] > 0


def test_choose_optimizer_by_size():
    assert choose_optimizer(get_config("kimi-k2-1t-a32b"))[1] == "adafactor"
    assert choose_optimizer(get_config("llama3.2-1b"))[1] == "adamw"


@pytest.mark.parametrize("arch", ["llama3.2-1b", "kimi-k2-1t-a32b",
                                  "hymba-1.5b", "whisper-base",
                                  "xlstm-1.3b", "internvl2-1b"])
def test_meta_models_allocate_nothing(arch):
    """Every family builds on meta, each parameter as the CPU build's."""
    cfg = get_smoke_config(arch)
    meta = build_model(cfg, device="meta").init(0)
    cpu = build_model(cfg, device="cpu").init(0)
    assert all(p.device.type == "meta" for p in meta.parameters())
    assert [(n, p.shape, p.dtype) for n, p in meta.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in cpu.named_parameters()]
    assert argument_bytes(meta) == sum(p.numel() * p.element_size()
                                       for p in cpu.parameters())
    full = build_model(get_config(arch), device="meta").init(0)
    assert param_count(full) > param_count(meta)


# -- both packages ------------------------------------------------------------

@pytest.fixture(scope="module")
def one_device():
    return (compat.make_mesh((1, 1), ("data", "model")),
            make_mesh((1, 1), ("data", "model")))


def _both(arch, kind, seq, batch, meshes):
    ref = ref_dry_run_cell(ref_smoke_config(arch),
                           RefShape("t", kind, seq, batch), meshes[0])
    port = dry_run_cell(get_smoke_config(arch),
                        ShapeConfig("t", kind, seq, batch), meshes[1])
    return ref, port


@pytest.mark.parametrize("arch,kind", [
    ("phi3-mini-3.8b", "train"), ("smollm-135m", "train"),
    ("llama3.2-1b", "train"), ("xlstm-1.3b", "train"),
    ("internvl2-1b", "prefill"), ("llama3.2-1b", "prefill"),
    ("deepseek-67b", "decode"), ("llama3.2-1b", "decode")])
def test_total_flops_match_the_reference(arch, kind, one_device):
    seq = 64 if kind == "decode" else 32
    ref, port = _both(arch, kind, seq, 8, one_device)
    assert port["n_chips"] == 1 and port["flops"] == port["global_flops"]
    assert abs(port["flops"] - ref["flops"]) / ref["flops"] < 0.05, \
        (ref["flops"], port["flops"])


def test_llama_smoke_step_matmul_flops_are_analytic(one_device):
    """Forward matmuls: q, k, v, o projections, the scores and p.v of
    the smoke config's plain attention, the SwiGLU's three products and
    the tied unembed; the gradient doubles each (its input and its
    weight or second operand), no remat in the smoke config."""
    cfg = get_smoke_config("llama3.2-1b")
    assert not cfg.remat and cfg.attn_impl == "ref"
    b, s = 8, 32
    t = b * s
    d, hd, hq, hkv = cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads
    layer = (2 * t * d * hq * hd + 2 * 2 * t * d * hkv * hd
             + 2 * t * hq * hd * d + 2 * 2 * b * hq * s * s * hd
             + 3 * 2 * t * d * cfg.d_ff)
    forward = cfg.num_layers * layer + 2 * t * d * cfg.vocab_size
    r = dry_run_cell(cfg, TINY_TRAIN, one_device[1])
    assert r["matmul_flops"] == 3 * forward
    assert r["torch_flops"] == 3 * forward      # FlopCounterMode agrees


# -- loops counted once -------------------------------------------------------

def _stepwise_and_once(arch, shape, mesh, **over):
    cfg = get_smoke_config(arch).scaled(**over)
    scfg = StepConfig()
    cfg = cell_config(cfg, shape, mesh, scfg)
    rules = rules_for(cfg, shape, mesh)
    out = []
    for once in (False, True):
        fn, _, _ = cell_step(cfg, shape, mesh, rules, scfg)
        out.append(hlo_cost.analyze(fn, count_loops_once=once))
    return out


@pytest.mark.parametrize("arch,shape", [
    ("xlstm-1.3b", TINY_PREFILL), ("granite-moe-1b-a400m", TINY_PREFILL),
    ("granite-moe-1b-a400m", TINY_DECODE)])
def test_loops_counted_once_equal_stepwise_forward(arch, shape, mesh24):
    a, b = _stepwise_and_once(arch, shape, mesh24)
    for k in ("flops", "bytes", "matmul_flops", "wire_bytes",
              "coll_bytes_by_op", "kernels"):
        assert a[k] == b[k], k
    assert b["ops"] < a["ops"]


def test_context_parallel_prefill_counted_once(mesh24):
    """Exact but for the sequence's first shards, which read a zero halo
    (one broadcast element) where the body counted for them reads one."""
    a, b = _stepwise_and_once("hymba-1.5b", ShapeConfig("p", "prefill", 32,
                                                        4), mesh24)
    for k in ("flops", "matmul_flops", "wire_bytes", "kernels"):
        assert a[k] == b[k], k
    assert abs(a["bytes"] - b["bytes"]) / a["bytes"] < 1e-3


@pytest.mark.parametrize("arch,over", [
    ("xlstm-1.3b", {"remat": True}), ("granite-moe-1b-a400m", {}),
    ("granite-moe-1b-a400m", {"remat": True})])
def test_loops_counted_once_bound_a_gradient(arch, over, mesh24):
    """The gradient's matmuls exactly; flops and bytes from below (at
    these sizes flops within 5%, bytes within 35%)."""
    a, b = _stepwise_and_once(arch, TINY_TRAIN, mesh24, **over)
    assert a["matmul_flops"] == b["matmul_flops"]
    assert a["wire_bytes"] == b["wire_bytes"]
    assert 0.95 * a["flops"] <= b["flops"] <= a["flops"]
    assert 0.65 * a["bytes"] <= b["bytes"] <= a["bytes"]


# -- the planner's cost -------------------------------------------------------

def _action(cache):
    op = ContainerOp(image="dryrun/double", fn=lambda part, **kw: part)
    m = T.MaRe((np.arange(4096, dtype=np.int32),), plan_cache=cache,
               executor=TR.Executor(mat_cache=TR.MaterializationCache()),
               device="cpu").map(op=op)
    m.collect()
    (prog,) = cache._programs.values()
    return prog


def test_program_cost_under_tracing():
    assert not TO.TRACER.enabled
    assert _action(T.PlanCache()).cost is None
    with TO.tracing() as t:
        prog = _action(T.PlanCache())
    assert set(prog.cost) == {"flops", "bytes", "wire_bytes"}
    assert prog.cost["bytes"] > 0
    dispatch = [e for e in t.events() if e["name"] == "dispatch"]
    assert dispatch and all(prog.cost.items() <= e["args"].items()
                            for e in dispatch[:1])


# -- the CLI ------------------------------------------------------------------

def test_cli_writes_a_line_a_cell_and_skips(tmp_path, capsys):
    out = tmp_path / "dryrun_torch.jsonl"
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                        "--shape", "long_500k", "--out", str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [(r["arch"], r["shape"]) for r in lines] == [
        ("smollm-135m", "decode_32k")]
    assert lines[0]["mesh"] == {"data": 16, "model": 16}
    assert lines[0]["memory"]["argument_bytes"] > 0
    printed = capsys.readouterr().out
    assert "SKIP smollm-135m x long_500k" in printed
    assert "ALL CELLS COUNTED" in printed


def test_meta_step_allocates_no_host_memory():
    """A full-size step on meta: argument bytes of a 1B model's state,
    none of it on the host."""
    cfg = get_config("llama3.2-1b")
    fn, args, _ = cell_step(cfg, TINY_TRAIN, None, None, StepConfig())
    assert argument_bytes(*args) > 10e9
    assert argument_bytes(*args, device=torch.device("cpu")) < 64
