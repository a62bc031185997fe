"""Dry-run library: count every (arch x shape x mesh) cell's work on the
meta device and turn it into the three roofline terms (the reference's
``launch/dryrun_lib.py``).

The reference lowers and compiles each cell for a TPU mesh and reads the
compiled module.  The port runs the cell's step once on the meta device
under the work counter (:mod:`repro_torch.launch.hlo_cost`): the model
is built there without drawing or allocating, every op runs on shapes
alone, and each hand-written kernel takes its meta route and reports its
function's work.  The mesh is the port's own (its shards run one after
another), so a step counted on it is the whole mesh's work.

Terms (NVIDIA H100 SXM 80GB data sheet, one card):
  compute    = flops (per device) / 989e12 FLOP/s (dense bf16)
  memory     = bytes (per device) / 3.35e12 B/s (HBM3)
  collective = ring wire bytes (per device) / 450e9 B/s (NVLink 4, one
               direction)

Per device is the global count over ``mesh.size``: an even partition
(the reference's counts are XLA's per-device module after SPMD).
Collectives are the port's own (``mare_tree``, ``hierarchical``, the
context-parallel SSM, the expert-parallel MoE), with the reference's ring
factors over the mesh's largest axis; the FSDP gathers XLA inserts for a
``fused`` step have no counterpart here, so a run that makes none of the
port's own collectives reports ``None``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.collectives import Mesh
from repro_torch.kernels.work import (BF16_FLOP_PER_S, HBM_BYTES_PER_S,
                                      LINK_BYTES_PER_S)
from repro_torch.launch import hlo_cost
from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig, param_count_analytic
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.sharding import (P, Rules, data_only_rules, make_rules,
                                  use_rules)
from repro_torch.train.step import StepConfig, TrainState, make_train_step

# H100 SXM 80GB hardware model (data sheet)
PEAK_FLOPS = BF16_FLOP_PER_S     # bf16 dense FLOP/s, tensor cores
HBM_BW = HBM_BYTES_PER_S         # B/s, HBM3
LINK_BW = LINK_BYTES_PER_S       # B/s, NVLink 4, one direction

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Rules / sharding selection per (arch x shape)
# ---------------------------------------------------------------------------

def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Rules:
    """The reference's rules: SSM / hybrid keep the sequence local and
    spread the batch over the whole mesh where it divides; a hybrid
    prefill with ``ssm_cp`` shards the sequence; decode never does."""
    seq_shard = cfg.family not in ("ssm", "hybrid")
    if cfg.family == "hybrid" and cfg.ssm_cp and shape.kind == "prefill":
        seq_shard = True
    if shape.is_decode:
        seq_shard = False
    rules = make_rules(mesh, fsdp=True, seq_shard=seq_shard)
    if cfg.family in ("ssm", "hybrid") and not shape.is_decode:
        axes_all = tuple(a for a in ("pod", "data", "model")
                         if a in mesh.shape)
        size_all = 1
        for a in axes_all:
            size_all *= int(mesh.shape[a])
        if shape.global_batch % size_all == 0:
            table = dict(rules.table)
            table["batch"] = axes_all
            if cfg.family == "ssm":
                table["hd"] = "model"
            rules = Rules(table=table, mesh_shape=rules.mesh_shape)
    return rules


def choose_optimizer(cfg: ModelConfig):
    """Adafactor above 10B params (factored second moments), AdamW
    below."""
    if param_count_analytic(cfg) > 10e9:
        return adafactor(), "adafactor"
    return adamw(), "adamw"


# ---------------------------------------------------------------------------
# input_specs — meta stand-ins for every model input
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device: torch.device = META) -> Dict[str, torch.Tensor]:
    """Batch stand-ins on ``device`` (meta: no allocation), the
    reference's shapes and dtypes.  For train: tokens + labels; audio adds
    stub frame embeddings; vlm adds stub patch embeddings (the text
    shrinks so that patches + text == shape.seq_len)."""
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.param_dtype
    i32 = torch.int32
    s_text = S - (cfg.num_patches if cfg.family == "vlm" else 0)

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        specs["tokens"] = spec((B, s_text), i32)
        specs["labels"] = spec((B, s_text), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = spec((B, s_text), i32)
    else:   # decode / long_decode: one new token (caches built apart)
        specs["tokens"] = spec((B,), i32)
    if cfg.family == "audio" and shape.kind != "decode":
        specs["frames"] = spec((B, cfg.encoder_seq, cfg.d_model), dt)
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        specs["patch_embeds"] = spec((B, cfg.num_patches, cfg.d_model), dt)
    return specs


def batch_shardings(specs: Dict[str, torch.Tensor], mesh: Mesh,
                    rules: Rules) -> Dict[str, P]:
    """Each input's partition spec under ``rules`` (the reference's
    ``NamedSharding``s without the mesh: every shard of the port's mesh
    lives on one device, so nothing lays the batch out by them)."""
    del mesh
    out = {}
    for k, v in specs.items():
        if v.ndim == 2 and k in ("tokens", "labels"):
            spec = rules.spec_for(("batch", "seq"), dims=v.shape)
        elif v.ndim == 3:
            spec = rules.spec_for(("batch", "seq", None), dims=v.shape)
        elif v.ndim == 1:
            spec = rules.spec_for(("batch",), dims=v.shape)
        else:
            spec = P()
        out[k] = spec
    return out


def _cache_sharding(leaf: torch.Tensor, cfg: ModelConfig,
                    shape: ShapeConfig, mesh: Mesh, rules: Rules) -> P:
    """Heuristic cache spec: batch dim -> data axes, cache-seq dim ->
    model axis (context-sharded KV for long decode)."""
    del cfg, mesh
    dims = list(leaf.shape)
    B = shape.global_batch
    logical: List[Optional[str]] = [None] * len(dims)
    for i, d in enumerate(dims):
        if d == B and "batch" not in logical:
            logical[i] = "batch"
        elif d >= 1024 and d >= shape.seq_len // 2:
            logical[i] = "kv_seq"
    return rules.spec_for(logical, dims=dims)


# ---------------------------------------------------------------------------
# Cell dry-run
# ---------------------------------------------------------------------------

def tensors_of(obj: Any, device: torch.device) -> List[torch.Tensor]:
    """Every tensor on ``device`` reachable from ``obj`` (a model, a
    state, a batch, caches), each storage once."""
    out: Dict[int, torch.Tensor] = {}
    seen: set = set()

    def walk(x):
        if id(x) in seen:
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            if x.device == device:
                out.setdefault(x.untyped_storage()._cdata, x)
        elif isinstance(x, nn.Module):
            for t in x.parameters():
                walk(t)
            for t in x.buffers():
                walk(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dict__"):
            for v in vars(x).values():
                walk(v)
    walk(obj)
    return list(out.values())


def argument_bytes(*objs: Any, device: torch.device = META) -> int:
    """Bytes of the tensors on ``device`` that ``objs`` hold: what a step
    is handed (parameters, optimizer state, batch, caches)."""
    return sum(t.untyped_storage().nbytes()
               for t in tensors_of(list(objs), device))


def cell_config(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                step_cfg: StepConfig) -> ModelConfig:
    """The reference's per-cell policy: activation-stationary MoE
    (``token_gather``) for decode, the context-parallel SSM for a hybrid
    prefill whose batch does not divide the mesh."""
    moe_mode = step_cfg.moe_mode
    if cfg.is_moe and shape.is_decode and moe_mode == "weight_gather":
        moe_mode = "token_gather"
    if cfg.is_moe and moe_mode != cfg.moe_mode:
        cfg = cfg.scaled(moe_mode=moe_mode)
    if cfg.family == "hybrid" and shape.kind == "prefill" and \
            shape.global_batch % mesh.size != 0:
        cfg = cfg.scaled(ssm_cp=True)
    return cfg


def cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Optional[Mesh],
              rules: Optional[Rules], step_cfg: StepConfig,
              device: torch.device = META, seed: int = 0):
    """(the cell's step as a function of no arguments, the arguments it
    is handed, the optimizer's name or None): the train step with the
    chosen optimizer and ``cosine_warmup(3e-4, 100, 10000)``, the prefill
    or one decode step over a cache of ``shape.seq_len``; built on
    ``device``."""
    model = build_model(cfg, device=device)
    specs = input_specs(cfg, shape, device)
    if shape.kind == "train":
        opt, opt_name = choose_optimizer(cfg)
        params = model.init(seed).trainable()
        state = TrainState(params=params, opt_state=opt.init(params),
                           step=torch.zeros((), dtype=torch.int32))
        step = make_train_step(model, opt, cosine_warmup(3e-4, 100, 10000),
                               step_cfg, mesh=mesh, rules=rules)
        return (lambda: step(state, specs)), (state, specs), opt_name
    params = model.init(seed)
    if shape.kind == "prefill":
        def prefill():
            with torch.no_grad(), use_rules(rules, mesh):
                return model.prefill(params, specs, shape.seq_len)
        return prefill, (params, specs), None
    with torch.no_grad(), use_rules(rules, mesh):
        if cfg.family == "audio":
            pre = {"tokens": torch.empty((shape.global_batch, 8),
                                         dtype=torch.int32, device=device),
                   "frames": specs["frames"] if "frames" in specs else
                   torch.empty((shape.global_batch, cfg.encoder_seq,
                                cfg.d_model), dtype=cfg.param_dtype,
                               device=device)}
            _, caches = model.prefill(params, pre, shape.seq_len)
        else:
            caches = model.init_cache(shape.global_batch, shape.seq_len)

    def decode():
        with torch.no_grad(), use_rules(rules, mesh):
            return model.decode_step(params, caches, specs["tokens"])
    return decode, (params, caches, specs), None


def dry_run_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                 extract_collectives: bool = True,
                 step_cfg: Optional[StepConfig] = None) -> Dict[str, Any]:
    """Count one cell's step on the meta device: the reference's result
    keys, ``flops`` / ``bytes`` per device (global over ``mesh.size``)
    beside ``global_flops`` / ``global_bytes``, ``torch_flops``
    (``FlopCounterMode``'s matmul-only count of the same run) in place of
    XLA's, ``memory`` (``argument_bytes`` exact, ``peak_bytes`` the
    arguments plus the counter's high-water mark), ``lower_s`` the meta
    run's wall, and each kernel's reported work."""
    scfg = step_cfg or StepConfig(grad_sync="fused")
    cfg = cell_config(cfg, shape, mesh, scfg)
    rules = data_only_rules(mesh) if scfg.grad_sync == "mare_tree" \
        else rules_for(cfg, shape, mesh)
    t0 = time.monotonic()
    fn, args, opt_name = cell_step(cfg, shape, mesh, rules, scfg)
    arg_bytes = argument_bytes(*args)
    with FlopCounterMode(display=False) as fc, \
            hlo_cost.Counter(count_loops_once=True) as counter:
        fn()
    lower_s = time.monotonic() - t0
    walk = counter.result()
    n_chips = mesh.size
    coll: Any = {}
    if extract_collectives:
        made = any(walk["coll_counts"].values())
        coll = {"bytes_by_op": walk["coll_bytes_by_op"],
                "counts": walk["coll_counts"],
                "wire_bytes": walk["wire_bytes"]} if made else None
    flops = walk["flops"] / n_chips
    byt = walk["bytes"] / n_chips
    return {
        "arch": cfg.name, "shape": shape.name,
        "mesh": dict(mesh.shape),
        "flops": flops, "bytes": byt,
        "global_flops": walk["flops"], "global_bytes": walk["bytes"],
        "matmul_flops": walk["matmul_flops"],
        "torch_flops": fc.get_total_flops(),
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": byt / HBM_BW,
        "collective_s": (coll["wire_bytes"] / LINK_BW if coll else None),
        "collectives": coll,
        "kernels": walk["kernels"],
        "memory": {"argument_bytes": arg_bytes,
                   "peak_bytes": arg_bytes + walk["peak_bytes"]},
        "optimizer": opt_name,
        "moe_mode": cfg.moe_mode if cfg.is_moe else None,
        "ssm_cp": cfg.ssm_cp,
        "lower_s": round(lower_s, 2),
        "n_chips": n_chips,
    }
