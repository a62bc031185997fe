"""The dry run's cells and input stand-ins through both packages: the
reference's ``tests/test_dryrun_specs.py`` cases, the port's
``input_specs`` (meta tensors) equal in shape and dtype to the
reference's ``ShapeDtypeStruct``s for every arch and shape, and the
cells' rules and the batch's and caches' specs equal to the reference's
on the production mesh's shape."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.launch.dryrun_lib as ref_lib
import repro_torch.configs as TC
from repro.launch.dryrun_lib import input_specs as ref_input_specs
from repro_torch.launch.dryrun_lib import (_cache_sharding, batch_shardings,
                                           cell_config, input_specs,
                                           rules_for, tensors_of)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.train.step import StepConfig

SKIPPED_ARCHS = {"kimi-k2-1t-a32b", "granite-moe-1b-a400m",
                 "phi3-mini-3.8b", "deepseek-67b", "smollm-135m",
                 "llama3.2-1b", "whisper-base", "internvl2-1b"}


@pytest.mark.parametrize("pkg", [RC, TC], ids=["reference", "port"])
def test_cell_count_and_skips(pkg):
    all_cells = pkg.cells(include_skipped=True)
    assert len(all_cells) == 40                      # 10 archs x 4 shapes
    runnable = [c for c in all_cells if c[2] is None]
    assert len(runnable) == 32                       # 8 long_500k skips
    skipped = [c for c in all_cells if c[2] is not None]
    assert {a for a, _, _ in skipped} == SKIPPED_ARCHS
    assert all(s == "long_500k" for _, s, _ in skipped)


def test_cells_agree():
    assert TC.cells(include_skipped=True) == RC.cells(include_skipped=True)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_input_specs_cover_all_model_inputs(arch):
    cfg = TC.get_config(arch)
    for shape in TC.SHAPES:
        if TC.shape_skip_reason(cfg, shape):
            continue
        specs = input_specs(cfg, shape)
        assert all(v.device.type == "meta" for v in specs.values())
        assert "tokens" in specs
        if shape.kind == "train":
            assert "labels" in specs
            assert specs["tokens"].shape[0] == shape.global_batch
        if shape.is_decode:
            assert tuple(specs["tokens"].shape) == (shape.global_batch,)
        if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
            assert "patch_embeds" in specs
            assert (specs["patch_embeds"].shape[1] +
                    specs["tokens"].shape[1]) == shape.seq_len
        if cfg.family == "audio" and shape.kind == "train":
            assert specs["frames"].shape[1] == cfg.encoder_seq


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    for rshape, tshape in zip(RC.SHAPES, TC.SHAPES):
        assert rshape.name == tshape.name
        ref = ref_input_specs(rcfg, rshape)
        got = input_specs(tcfg, tshape)
        assert sorted(ref) == sorted(got), (arch, tshape.name)
        for k, r in ref.items():
            assert tuple(got[k].shape) == tuple(r.shape), (arch, k)
            assert str(got[k].dtype).replace("torch.", "") == \
                np.dtype(r.dtype).name, (arch, k, got[k].dtype, r.dtype)
        assert all(v.device == torch.device("meta") for v in got.values())


class _MeshShape:
    """The reference's rules read a mesh's shape alone; its 256 devices
    do not exist in this process."""

    def __init__(self, mesh):
        self.shape = dict(mesh.shape)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_rules_and_specs_match_the_reference(arch, monkeypatch):
    monkeypatch.setattr(ref_lib, "NamedSharding", lambda mesh, spec: spec)
    mesh = make_production_mesh()
    fake = _MeshShape(mesh)
    for rshape, tshape in zip(RC.SHAPES, TC.SHAPES):
        tcfg = TC.get_config(arch)
        if TC.shape_skip_reason(tcfg, tshape):
            continue
        tcfg = cell_config(tcfg, tshape, mesh, StepConfig())
        rcfg = RC.get_config(arch).scaled(moe_mode=tcfg.moe_mode,
                                          ssm_cp=tcfg.ssm_cp)
        rrules = ref_lib.rules_for(rcfg, rshape, fake)
        trules = rules_for(tcfg, tshape, mesh)
        assert trules.table == dict(rrules.table), (arch, tshape.name)
        ref = ref_lib.batch_shardings(ref_input_specs(rcfg, rshape), fake,
                                      rrules)
        got = batch_shardings(input_specs(tcfg, tshape), mesh, trules)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in ref.items()}, (arch, tshape.name)
        if tshape.is_decode and tcfg.family != "audio":
            caches = build_model(tcfg, device="meta").init_cache(
                tshape.global_batch, tshape.seq_len)
            leaves = {tuple(t.shape) for t in tensors_of(
                caches, torch.device("meta"))}
            assert leaves, (arch, tshape.name)
            for dims in sorted(leaves):
                leaf = jax.ShapeDtypeStruct(dims, np.float32)
                assert tuple(_cache_sharding(
                    torch.empty(dims, device="meta"), tcfg, tshape, mesh,
                    trules)) == tuple(ref_lib._cache_sharding(
                        leaf, rcfg, rshape, fake, rrules)), (arch, dims)
