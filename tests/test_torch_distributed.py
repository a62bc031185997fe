"""The reference's multi-device scripts (``tests/distributed/``) as twins:
the port on the same meshes, in process, against the reference's outputs.

The reference needs 8 devices, so it runs once, in one module-scoped
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(as ``tests/test_torch_mare_8shard.py`` runs it), and writes every input
and output to one ``.npz`` (and its counters to a ``.json``).  The port
builds the same meshes as logical shards on the CPU
(``launch/mesh.make_mesh``).  Seven scripts are twinned: ``mare_e2e``,
``keyed_skew``, ``ingest_waves``, ``moe_sharded``, ``grad_sync``,
``elastic_reshard`` and ``ssm_cp`` (``dryrun_small`` comes with the dry
run).  Limits are the scripts' own:

* MaRe outputs, counters and elastic restores: bit-equal;
* MoE: 1e-4 in both layouts, at capacity factors 8.0 and 1.25, with
  ``dropped`` and the aux loss bit-equal;
* grad sync: one AdamW step of ``mare_tree`` at depths 1-3 within 1e-5
  of the port's fused step, as the script's own bound; and each sync
  (``mare_tree`` at depths 1-3, with and without compression, the
  residual included; ``hierarchical`` on a pod x data mesh) within 1e-5
  of the reference's.  Across the two packages an element whose
  gradient is below ``GRAD_FLOOR`` is held to AdamW's own step instead,
  the rule of ``tests/test_torch_train.py``;
* SSM context parallelism: 1e-4.

Beyond the scripts, the models' routing under a mesh: the MoE and hybrid
smoke models' prefills under ``use_rules`` (expert-parallel FFN,
context-parallel SSM block) against the reference's, at 1e-4.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.checkpoint import CheckpointManager, rescale
from repro_torch.configs import get_smoke_config
from repro_torch.core.shuffle import grouped_all_to_all
from repro_torch.io import (WaveRunner, fasta_source, ingest, make_backend,
                            unpack_records)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ssm_cp import ssm_block_context_parallel
from repro_torch.optim import adamw, named_tree
from repro_torch.optim.compression import init_residual, stack_key
from repro_torch.optim.schedule import constant
from repro_torch.sharding import data_only_rules, make_rules, use_rules
from repro_torch.train import (StepConfig, TrainState, init_train_state,
                               make_train_step)
from repro_torch.train.step import RESIDUAL_SHARD

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32,
            num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
            dtype="float32", remat=False)
MOE = dict(name="m", family="moe", num_layers=1, d_model=32, num_heads=2,
           num_kv_heads=2, d_ff=0, moe_d_ff=16, num_experts=8,
           experts_per_token=2, vocab_size=64, dtype="float32",
           remat=False, capacity_factor=8.0)
HYBRID = dict(name="t", family="hybrid", num_layers=1, d_model=32,
              num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
              ssm_state=8, ssm_chunk=8, dtype="float32", remat=False)
CAPACITY_FACTORS = (8.0, 1.25)
MOE_MODES = ("weight_gather", "token_gather")
DEPTHS = (1, 2, 3)
BACKENDS = ("local", "hdfs", "swift", "s3")
TOL = 1e-5
GRAD_FLOOR = 1e-6
#: AdamW's first step moves an element by at most lr (1 + weight decay).
FLOOR_TOL = 2.2e-3
MOE_TOL = 1e-4
CP_TOL = 1e-4
#: An int8 quantizer input this close to a rounding boundary, in levels.
BOUNDARY = 1e-3

REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    # at most 4 cores: the suite's other workers time their own code
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:4])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["REPRO_SEGMENT_AUTOTUNE"] = "0"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import compat
    out, work = sys.argv[1], sys.argv[2]
    TINY, MOE, HYBRID = (json.loads(a) for a in sys.argv[3:6])
    A, M = {}, {}

    def put(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(f"{prefix}/{k}", v)
            else:
                A[f"{prefix}/{k}"] = np.asarray(v)

    assert jax.device_count() == 8

    # -- mare_e2e ---------------------------------------------------------
    from repro.core import MaRe, PlanCache, TextFile
    rng = np.random.default_rng(0)
    dna = rng.integers(0, 4, size=1000).astype(np.int32)
    A["e2e/dna"] = dna
    res = (MaRe((dna,))
           .map(input_mount=TextFile("/dna"), output_mount=TextFile("/count"),
                image="ubuntu", command="grep-count 2 3")
           .reduce(input_mount=TextFile("/counts"),
                   output_mount=TextFile("/sum"), image="ubuntu",
                   command="awk-sum"))
    A["e2e/gc"] = np.asarray(res.collect(shard=0)[0])
    scores = rng.normal(size=500).astype(np.float32)
    payload = np.arange(500, dtype=np.int32)
    A["e2e/scores"] = scores
    for depth in (1, 2, 3):
        r = MaRe((scores, payload)).reduce(image="toolbox/topk", k=30,
                                           depth=depth)
        s_out, p_out = r.collect(shard=0)
        A[f"e2e/topk{depth}/scores"] = np.asarray(s_out)
        A[f"e2e/topk{depth}/payload"] = np.asarray(p_out)
    vals = np.arange(64, dtype=np.int32)
    m3 = MaRe((vals,)).repartition_by(lambda recs: recs[0] % 5)
    A["e2e/repart/collect"] = np.asarray(m3.collect()[0])
    A["e2e/repart/records"] = np.asarray(jax.device_get(
        m3.dataset.records[0]))
    A["e2e/repart/counts"] = np.asarray(jax.device_get(m3.dataset.counts))

    # grouped_all_to_all (the structured exchange MoE dispatch builds on)
    from repro.core.shuffle import grouped_all_to_all
    mesh = compat.make_mesh((8,), ("data",))
    gx = rng.normal(size=(8 * 6, 4)).astype(np.float32)
    gid = rng.integers(0, 20, 8 * 6).astype(np.int32)
    A["e2e/grouped/x"], A["e2e/grouped/ids"] = gx, gid

    def grouped(xl, gl):
        r, c = grouped_all_to_all(xl, gl, "data", 8, capacity=3)
        return r[None], c[None]

    r, c = compat.shard_map(grouped, mesh=mesh,
                            in_specs=(P("data"), P("data")),
                            out_specs=(P("data"), P("data")),
                            check_vma=False)(gx, gid)
    A["e2e/grouped/recv"], A["e2e/grouped/counts"] = (np.asarray(r),
                                                      np.asarray(c))

    # -- keyed_skew -------------------------------------------------------
    rng = np.random.default_rng(5)
    n, num_keys, hot, frac = 2048, 32, 7, 0.9
    keys = np.where(rng.random(n) < frac, hot,
                    rng.integers(0, num_keys, n)).astype(np.int32)
    kvals = rng.integers(0, 10, n).astype(np.int32)
    A["skew/keys"], A["skew/vals"] = keys, kvals

    def keyed(**kw):
        return MaRe((keys, kvals), plan_cache=PlanCache()).reduce_by_key(
            lambda r: r[0], value_by=lambda r: (r[1],), op="sum",
            num_keys=num_keys, combiner=False, **kw)

    runs = {"sal": keyed(salt=8), "raw": keyed()}
    for name, m in runs.items():
        k_out, (s_out,), c_out = m.collect()
        A[f"skew/{name}/keys"] = np.asarray(k_out)
        A[f"skew/{name}/sum"] = np.asarray(s_out)
        A[f"skew/{name}/count"] = np.asarray(c_out)
        M[f"skew/{name}"] = m.report().diagnostics
    tight = M["skew/raw"]["stage0.max_send_count"]
    rerun = keyed(capacity=tight)
    k_out, (s_out,), c_out = rerun.collect()
    A["skew/rerun/keys"] = np.asarray(k_out)
    A["skew/rerun/sum"] = np.asarray(s_out)
    A["skew/rerun/count"] = np.asarray(c_out)
    M["skew/rerun"] = rerun.report().diagnostics

    # -- ingest_waves -----------------------------------------------------
    from repro.core import collect
    from repro.io import WaveRunner, fasta_source, ingest, make_backend
    rng = np.random.default_rng(11)
    seq = "".join(np.array(list("ATGC"))[rng.integers(0, 4, 20_000)])
    path = os.path.join(work, "genome.fa")
    with open(path, "w") as f:
        f.write(">chr1\\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i:i + 60] + "\\n")
    M["waves/path"] = path
    mesh = compat.make_mesh((8,), ("data",))
    ds = ingest(fasta_source(path, split_bytes=1 << 10), mesh)
    got = collect(ds)
    A["waves/ingest/data"] = np.asarray(got["data"])
    A["waves/ingest/len"] = np.asarray(got["len"])
    A["waves/ingest/counts"] = np.asarray(jax.device_get(ds.counts))
    for kind in ("local", "hdfs", "swift", "s3"):
        src = fasta_source(path, backend=make_backend(kind, path),
                           split_bytes=1 << 10)
        runner = (WaveRunner(src, mesh=mesh, wave_bytes=1 << 13)
                  .map(image="ubuntu", command="grep-chars GC")
                  .reduce(image="ubuntu", command="awk-sum"))
        (total,) = runner.collect()
        A[f"waves/{kind}/total"] = np.asarray(total)
        M[f"waves/{kind}/num_waves"] = int(runner.stats["num_waves"])
    total = (MaRe.from_source(fasta_source(path, split_bytes=1 << 10),
                              mesh=mesh)
             .map(image="ubuntu", command="grep-chars GC")
             .reduce(image="ubuntu", command="awk-sum")
             .collect(shard=0))
    A["waves/from_source/total"] = np.asarray(total[0])

    # -- moe_sharded ------------------------------------------------------
    from repro.models.common import ModelConfig
    from repro.models import moe as moe_lib
    from repro.sharding import make_rules, use_rules
    cfg = ModelConfig(**MOE)
    p = moe_lib.init_moe(jax.random.PRNGKey(0), cfg)
    put("moe/p", p)
    mesh = compat.make_mesh((2, 4), ("data", "model"))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 8, 32)),
                    jnp.float32)
    A["moe/x"] = np.asarray(x)
    y_dense, _ = moe_lib.moe_ffn_dense(p, x, cfg)
    A["moe/dense"] = np.asarray(y_dense)
    for cf in (8.0, 1.25):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        for mode in ("weight_gather", "token_gather"):
            with use_rules(make_rules(mesh), mesh):
                y_s, st = jax.jit(lambda p, x: moe_lib.moe_ffn_sharded(
                    p, x, c, mode=mode))(p, x)
            A[f"moe/{cf}/{mode}/y"] = np.asarray(y_s)
            A[f"moe/{cf}/{mode}/dropped"] = np.asarray(st.dropped)
            A[f"moe/{cf}/{mode}/aux"] = np.asarray(st.aux_loss)

    # -- grad_sync --------------------------------------------------------
    from repro.models import build_model
    from repro.optim import adamw
    from repro.optim.schedule import constant
    from repro.train import StepConfig, init_train_state, make_train_step
    from repro.sharding import data_only_rules
    cfg = ModelConfig(**TINY)
    model = build_model(cfg)
    opt = adamw()
    mesh = compat.make_mesh((8,), ("data",))
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, 64, (16, 16)),
                                   jnp.int32),
             "labels": jnp.asarray(rng.integers(0, 64, (16, 16)),
                                   jnp.int32)}
    A["gs/tokens"], A["gs/labels"] = (np.asarray(batch["tokens"]),
                                      np.asarray(batch["labels"]))
    state = init_train_state(model, opt, jax.random.PRNGKey(0))
    put("gs/init", state.params)
    put("gs/grad", jax.grad(lambda q: model.loss(q, batch)[0])(
        state.params))
    s_f, m_f = jax.jit(make_train_step(model, opt, constant(1e-3),
                                       StepConfig(grad_sync="fused")))(
        state, batch)
    put("gs/fused", s_f.params)
    M["gs/fused/loss"] = float(m_f["loss"])
    rules = data_only_rules(mesh)
    bs = jax.tree.map(lambda x: jax.device_put(
        x, NamedSharding(mesh, P("data"))), batch)
    for comp in (False, True):
        st0 = init_train_state(model, opt, jax.random.PRNGKey(0),
                               compression=comp)
        for depth in (1, 2, 3):
            step_t = make_train_step(model, opt, constant(1e-3),
                                     StepConfig(grad_sync="mare_tree",
                                                tree_depth=depth,
                                                compression=comp),
                                     mesh=mesh, rules=rules)
            s_t, m_t = jax.jit(step_t)(st0, bs)
            name = f"gs/tree{depth}" + ("c" if comp else "")
            put(name + "/params", s_t.params)
            M[name + "/loss"] = float(m_t["loss"])
            M[name + "/grad_norm"] = float(m_t["grad_norm"])
            if comp:
                put(name + "/residual", s_t.residual)
                # every device's copy of one residual leaf
                leaf = s_t.residual["embed"]["table"]
                for sh in leaf.addressable_shards:
                    A[f"{name}/residual_dev/{sh.device.id}"] = np.asarray(
                        sh.data)
    mesh_h = compat.make_mesh((2, 4), ("pod", "data"))
    step_h = make_train_step(model, opt, constant(1e-3),
                             StepConfig(grad_sync="hierarchical"),
                             mesh=mesh_h, rules=data_only_rules(mesh_h))
    s_h, m_h = jax.jit(step_h)(state, batch)
    put("gs/hier/params", s_h.params)
    M["gs/hier/loss"] = float(m_h["loss"])

    # -- elastic_reshard --------------------------------------------------
    from repro.checkpoint import CheckpointManager
    state = init_train_state(model, adamw(), jax.random.PRNGKey(0))
    ckpt = os.path.join(work, "ckpt")
    mgr = CheckpointManager(ckpt)
    mgr.save(1, state, blocking=True)
    mesh4 = compat.make_mesh((4, 2), ("data", "model"))
    shard = jax.tree.map(lambda _: NamedSharding(mesh4, P()), state)
    restored = mgr.restore(state, shardings=shard)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: bool(jnp.all(a == b)), state.params, restored.params))
    put("elastic/params", state.params)
    M["elastic/dir"] = ckpt

    # -- ssm_cp -----------------------------------------------------------
    from repro.models import ssm as ssm_lib
    from repro.models.ssm_cp import ssm_block_context_parallel
    cfg = ModelConfig(**HYBRID)
    p = ssm_lib.init_ssm(jax.random.PRNGKey(0), cfg)
    put("cp/p", p)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 64, 32)),
                    jnp.float32)
    A["cp/x"] = np.asarray(x)
    A["cp/ref"] = np.asarray(ssm_lib.ssm_block(p, x, cfg)[0])
    mesh = compat.make_mesh((1, 8), ("data", "model"))
    xs = jax.device_put(x, NamedSharding(mesh, P(None, "model", None)))
    A["cp/cp"] = np.asarray(jax.jit(lambda x: ssm_block_context_parallel(
        p, x, cfg, mesh, batch_axes=None))(xs))

    # -- the models' routing under a mesh ---------------------------------
    from repro.configs import get_smoke_config
    for arch, shape in (("granite-moe-1b-a400m", (2, 4)),
                        ("hymba-1.5b", (1, 8))):
        cfg = get_smoke_config(arch).scaled(ssm_cp=True)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(1))
        put(f"route/{arch}/params", params)
        tokens = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32)
        A[f"route/{arch}/tokens"] = tokens
        mesh = compat.make_mesh(shape, ("data", "model"))
        with use_rules(make_rules(mesh), mesh):
            logits, _ = jax.jit(lambda p, t: model.prefill(
                p, {"tokens": t}, 16))(params, jnp.asarray(tokens))
        A[f"route/{arch}/logits"] = np.asarray(logits)

    np.savez(out, **A)
    with open(out + ".json", "w") as f:
        json.dump(M, f)
    print("OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("reference")
    out = str(work / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, out, str(work),
         json.dumps(TINY), json.dumps(MOE), json.dumps(HYBRID)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-4000:]
    with np.load(out) as data:
        arrays = {k: data[k] for k in data.files}
    with open(out + ".json") as f:
        meta = json.load(f)
    return arrays, meta


def _tree(arrays, prefix):
    """The nested dict the reference wrote under ``prefix``."""
    out = {}
    for key, val in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(want, got):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.shape, got.shape, want.dtype, got.dtype)
    assert np.array_equal(want, got)


def _cpu_mesh(shape, axes):
    return make_mesh(shape, axes)


# -- mare_e2e ---------------------------------------------------------------

def test_mare_e2e(ref):
    """GC count (Listing 1), the top-k reduce at depths 1-3 and
    ``repartition_by``'s co-location over 8 shards: bit-equal."""
    A, _ = ref
    dna = A["e2e/dna"]
    res = (T.MaRe((dna,), num_shards=8, device="cpu")
           .map(input_mount=T.TextFile("/dna"),
                output_mount=T.TextFile("/count"), image="ubuntu",
                command="grep-count 2 3")
           .reduce(input_mount=T.TextFile("/counts"),
                   output_mount=T.TextFile("/sum"), image="ubuntu",
                   command="awk-sum")).collect(shard=0)
    _eq(A["e2e/gc"], res[0])
    assert int(res[0][0]) == int(np.sum((dna == 2) | (dna == 3)))
    scores = A["e2e/scores"]
    payload = np.arange(500, dtype=np.int32)
    for depth in DEPTHS:
        s_out, p_out = T.MaRe((scores, payload), num_shards=8,
                              device="cpu").reduce(
            image="toolbox/topk", k=30, depth=depth).collect(shard=0)
        _eq(A[f"e2e/topk{depth}/scores"], s_out)
        _eq(A[f"e2e/topk{depth}/payload"], p_out)
    m3 = T.MaRe((np.arange(64, dtype=np.int32),), num_shards=8,
                device="cpu").repartition_by(lambda recs: recs[0] % 5)
    _eq(A["e2e/repart/collect"], m3.collect()[0])
    _eq(A["e2e/repart/records"], m3.dataset.records[0])
    _eq(A["e2e/repart/counts"], m3.dataset.counts)


def test_grouped_all_to_all(ref):
    """``shuffle.grouped_all_to_all`` over 8 shards of 6 rows, capacity 3
    (so some rows drop): each shard's received ``[8, 3, d]`` blocks and
    counts bit-equal to the reference's under ``shard_map``."""
    A, _ = ref
    mesh = _cpu_mesh((8,), ("data",))
    xs = list(torch.from_numpy(A["e2e/grouped/x"]).split(6))
    ids = list(torch.from_numpy(A["e2e/grouped/ids"]).split(6))
    got = grouped_all_to_all(xs, ids, mesh, "data", capacity=3)
    for s, (recv, counts) in enumerate(got):
        _eq(A["e2e/grouped/recv"][s], recv)
        _eq(A["e2e/grouped/counts"][s], counts)


# -- keyed_skew -------------------------------------------------------------

def test_keyed_skew(ref):
    """The salted two-hop keyed exchange, the single hop and the re-plan
    at the reported tight capacity: outputs and every stage counter
    bit-equal, and the script's own properties."""
    A, M = ref
    keys, vals = A["skew/keys"], A["skew/vals"]

    def keyed(**kw):
        return T.MaRe((keys, vals), num_shards=8, device="cpu",
                      plan_cache=T.PlanCache()).reduce_by_key(
            lambda r: r[0], value_by=lambda r: (r[1],), op="sum",
            num_keys=32, combiner=False, **kw)

    runs = {"sal": keyed(salt=8), "raw": keyed()}
    runs["rerun"] = keyed(capacity=M["skew/raw"]["stage0.max_send_count"])
    for name, m in runs.items():
        k_out, (s_out,), c_out = m.collect()
        _eq(A[f"skew/{name}/keys"], k_out)
        _eq(A[f"skew/{name}/sum"], s_out)
        _eq(A[f"skew/{name}/count"], c_out)
        assert m.report().diagnostics == M[f"skew/{name}"], name
    diag = {k: m.report().diagnostics for k, m in runs.items()}
    assert diag["sal"]["stage0.shuffle_dropped"] == 0
    assert diag["sal"]["stage0.exchange_buffer_rows"] < \
        diag["raw"]["stage0.exchange_buffer_rows"]
    assert diag["rerun"]["stage0.shuffle_dropped"] == 0


# -- ingest_waves -----------------------------------------------------------

def test_ingest_waves(ref):
    """8-shard ingestion and the GC count through every storage backend in
    out-of-core waves, and ``from_source``: bit-equal records, totals and
    wave counts."""
    A, M = ref
    path = M["waves/path"]
    ds = ingest(fasta_source(path, split_bytes=1 << 10), num_shards=8,
                device="cpu")
    got = T.collect(ds)
    _eq(A["waves/ingest/data"], got["data"])
    _eq(A["waves/ingest/len"], got["len"])
    _eq(A["waves/ingest/counts"], ds.counts)
    assert sorted(r for r in unpack_records(got) if r) == sorted(
        r for r in unpack_records({"data": A["waves/ingest/data"],
                                   "len": A["waves/ingest/len"]}) if r)
    for kind in BACKENDS:
        src = fasta_source(path, backend=make_backend(kind, path),
                           split_bytes=1 << 10)
        runner = (WaveRunner(src, num_shards=8, device="cpu",
                             wave_bytes=1 << 13)
                  .map(image="ubuntu", command="grep-chars GC")
                  .reduce(image="ubuntu", command="awk-sum"))
        (total,) = runner.collect()
        _eq(A[f"waves/{kind}/total"], total)
        assert runner.stats["num_waves"] == M[f"waves/{kind}/num_waves"]
    total = (T.MaRe.from_source(fasta_source(path, split_bytes=1 << 10),
                                num_shards=8, device="cpu")
             .map(image="ubuntu", command="grep-chars GC")
             .reduce(image="ubuntu", command="awk-sum")
             .collect(shard=0))
    _eq(A["waves/from_source/total"], total[0])


# -- moe_sharded ------------------------------------------------------------

def _moe_params(A):
    return {k: torch.from_numpy(v) for k, v in _tree(A, "moe/p").items()}


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("mode", MOE_MODES)
def test_moe_sharded(ref, mode, cf):
    """The expert-parallel FFN on a (data 2, model 4) mesh: within 1e-4
    of the reference's sharded output, ``dropped`` and the aux loss
    bit-equal; at capacity factor 8.0 nothing drops and both equal the
    dense path within 1e-4 (the script's own check)."""
    A, _ = ref
    cfg = ModelConfig(**{**MOE, "capacity_factor": cf})
    p, x = _moe_params(A), torch.from_numpy(A["moe/x"])
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    with use_rules(make_rules(mesh), mesh):
        y, st = moe_lib.moe_ffn(p, x, cfg, mode=mode)
    want = A[f"moe/{cf}/{mode}/y"]
    assert float(np.abs(y.numpy() - want).max()) < MOE_TOL
    _eq(A[f"moe/{cf}/{mode}/dropped"], st.dropped)
    _eq(A[f"moe/{cf}/{mode}/aux"], st.aux_loss)
    if cf == 8.0:
        assert float(st.dropped) == 0.0
        assert float(np.abs(y.numpy() - A["moe/dense"]).max()) < MOE_TOL
    else:
        assert float(st.dropped) > 0, "capacity 1.25 should drop here"


def test_moe_without_a_model_axis_is_dense(ref):
    """No mesh, or a mesh without a ``model`` axis: the dense path (the
    dispatch kernel's plain version on the CPU)."""
    A, _ = ref
    cfg = ModelConfig(**MOE)
    p, x = _moe_params(A), torch.from_numpy(A["moe/x"])
    dense, _ = moe_lib.moe_ffn_dense(p, x, cfg)
    mesh = _cpu_mesh((8,), ("data",))
    with use_rules(data_only_rules(mesh), mesh):
        y, st = moe_lib.moe_ffn(p, x, cfg)
    assert torch.equal(y, dense) and float(st.dropped) == 0.0
    assert float(np.abs(dense.numpy() - A["moe/dense"]).max()) < MOE_TOL


# -- grad_sync --------------------------------------------------------------

def _gs_state(A, compression=False):
    cfg = ModelConfig(**TINY)
    params = params_from_numpy(_tree(A, "gs/init"), cfg,
                               device="cpu").trainable()
    return TrainState(params=params, opt_state=adamw().init(params),
                      step=torch.zeros((), dtype=torch.int32),
                      residual=init_residual(params) if compression else ())


def _gs_batch(A):
    return {"tokens": torch.from_numpy(A["gs/tokens"]),
            "labels": torch.from_numpy(A["gs/labels"])}


def _named(A, prefix):
    return named_tree(params_from_numpy(_tree(A, prefix),
                                        ModelConfig(**TINY), device="cpu"))


def _worst(diff):
    return float(diff.max()) if diff.numel() else 0.0


def _close(want, got, floor=None):
    """Every leaf within TOL; elements in ``floor`` within FLOOR_TOL."""
    assert set(want) == set(got)
    for k in want:
        diff = (want[k].detach() - got[k].detach()).abs()
        if floor is not None:
            assert _worst(diff[floor[k]]) <= FLOOR_TOL, k
            diff = diff[~floor[k]]
        assert _worst(diff) <= TOL, (k, _worst(diff))


def _step(A, sync, depth=2, compression=False, mesh_shape=(8,),
          axes=("data",)):
    mesh = _cpu_mesh(mesh_shape, axes)
    model = build_model(ModelConfig(**TINY), device="cpu")
    step = make_train_step(model, adamw(), constant(1e-3),
                           StepConfig(grad_sync=sync, tree_depth=depth,
                                      compression=compression),
                           mesh=mesh, rules=data_only_rules(mesh))
    return step(_gs_state(A, compression), _gs_batch(A))


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("compression", [False, True],
                         ids=["exact", "int8"])
def test_grad_sync_mare_tree(ref, depth, compression):
    """One AdamW step of ``mare_tree`` over 8 data shards: the loss, the
    parameters and (with compression) the kept error-feedback residual
    against the reference's; without compression also within 1e-5 of the
    port's fused step (the script's own bound)."""
    A, M = ref
    floor = {k: v.abs() < GRAD_FLOOR for k, v in _named(A, "gs/grad").items()}
    state, metrics = _step(A, "mare_tree", depth, compression)
    name = f"gs/tree{depth}" + ("c" if compression else "")
    assert abs(float(metrics["loss"]) - M[name + "/loss"]) <= TOL
    assert abs(float(metrics["grad_norm"]) - M[name + "/grad_norm"]) <= \
        TOL * M[name + "/grad_norm"]
    got = named_tree(state.params)
    _close(_named(A, name + "/params"), got, floor)
    if compression:
        _residual_close(A, _named(A, name + "/residual"), state.residual)
        return
    fused, _ = make_train_step(
        build_model(ModelConfig(**TINY), device="cpu"), adamw(),
        constant(1e-3), StepConfig())(_gs_state(A), _gs_batch(A))
    _close(named_tree(fused.params), got)
    _close(_named(A, "gs/fused"), named_tree(fused.params), floor)


def _residual_close(A, want, got):
    """The kept residual within TOL, but for elements whose quantizer
    input lies within ``BOUNDARY`` of a level of a rounding boundary: f32
    gradients 1e-8 apart may round those to neighbouring int8 levels in
    the two packages, so their residuals may differ by one level."""
    state = _gs_state(A)
    b = {k: v[RESIDUAL_SHARD * 2:RESIDUAL_SHARD * 2 + 2]
         for k, v in _gs_batch(A).items()}
    model = build_model(ModelConfig(**TINY), device="cpu")
    model.loss(state.params, b)[0].backward()
    grads = {k: p.grad for k, p in named_tree(state.params).items()}
    amax = {}
    for k, g in grads.items():
        key = stack_key(k)
        amax[key] = max(amax.get(key, 0.0), float(g.abs().max()))
    for k, g in grads.items():
        level = amax[stack_key(k)] / 127.0
        r = g / level
        edge = ((r - torch.floor(r)) - 0.5).abs() < BOUNDARY
        diff = (want[k] - got[k]).abs()
        assert _worst(diff[edge]) <= level + TOL, k
        assert _worst(diff[~edge]) <= TOL, (k, _worst(diff[~edge]))


def test_grad_sync_keeps_the_first_shards_residual(ref):
    """The reference returns its state unchecked as replicated
    (``out_specs=P()``): its residual reads as device 0's copy, while
    the devices' copies differ.  The port keeps shard 0's
    (``RESIDUAL_SHARD``)."""
    A, _ = ref
    devs = [A[f"gs/tree2c/residual_dev/{i}"] for i in range(8)]
    assert any(not np.array_equal(devs[0], d) for d in devs[1:])
    _eq(devs[0], A["gs/tree2c/residual/embed/table"])
    assert RESIDUAL_SHARD == 0


def test_grad_sync_hierarchical(ref):
    """``hierarchical`` on a (pod 2, data 4) mesh: the shards' gradients
    summed over ``data``, then ``pod``; the reference's step (the fused
    one under the mesh's rules) within 1e-5, and the port's fused step."""
    A, M = ref
    floor = {k: v.abs() < GRAD_FLOOR for k, v in _named(A, "gs/grad").items()}
    state, metrics = _step(A, "hierarchical", mesh_shape=(2, 4),
                           axes=("pod", "data"))
    assert abs(float(metrics["loss"]) - M["gs/hier/loss"]) <= TOL
    _close(_named(A, "gs/hier/params"), named_tree(state.params), floor)
    fused, _ = make_train_step(
        build_model(ModelConfig(**TINY), device="cpu"), adamw(),
        constant(1e-3), StepConfig())(_gs_state(A), _gs_batch(A))
    _close(named_tree(fused.params), named_tree(state.params))


# -- elastic_reshard ----------------------------------------------------------

def test_elastic_reshard(ref):
    """The reference's 8-shard checkpoint restored through ``rescale`` onto
    a (data 4, model 2) mesh, replicated and with the model's logical
    axes: every parameter bit-equal, each sharding dividing its leaf."""
    A, M = ref
    cfg = ModelConfig(**TINY)
    model = build_model(cfg, device="cpu")
    mesh4 = _cpu_mesh((4, 2), ("data", "model"))
    want = _named(A, "elastic/params")
    for axes in (None, model.logical_axes()):
        state = init_train_state(model, adamw(), 7)
        restored, shardings = rescale(CheckpointManager(M["elastic/dir"]),
                                      state,
                                      mesh4, make_rules(mesh4),
                                      logical_axes=axes)
        got = named_tree(restored.params)
        assert set(got) == set(want) == set(shardings)
        for k in want:
            assert torch.equal(want[k], got[k].detach()), k
            shardings[k].check(got[k].shape)
            if axes is None:
                assert tuple(shardings[k].spec) == ()
        assert all(float(v.abs().max()) == 0.0
                   for v in restored.opt_state.m.values())
    assert tuple(shardings["blocks.0.mlp.w1"].spec) == ("data", "model")


# -- ssm_cp -----------------------------------------------------------------

def test_ssm_context_parallel(ref):
    """The context-parallel SSM block on a (data 1, model 8) mesh (64
    positions, 8 a shard, chunks of 8): within 1e-4 of the reference's
    cp block and of the unsharded block, the port's and the reference's."""
    A, _ = ref
    cfg = ModelConfig(**HYBRID)
    p = {k: torch.from_numpy(v) for k, v in _tree(A, "cp/p").items()}
    x = torch.from_numpy(A["cp/x"])
    mesh = _cpu_mesh((1, 8), ("data", "model"))
    y = ssm_block_context_parallel(p, x, cfg, mesh, batch_axes=None)
    y_block, _ = ssm_lib.ssm_block(p, x, cfg)
    for want in (A["cp/cp"], A["cp/ref"], y_block.numpy()):
        assert float(np.abs(y.numpy() - want).max()) < CP_TOL


# -- the models' routing under a mesh --------------------------------------

@pytest.mark.parametrize("arch,shape", [("granite-moe-1b-a400m", (2, 4)),
                                        ("hymba-1.5b", (1, 8))])
def test_prefill_under_a_mesh_matches_reference(ref, arch, shape):
    """The MoE and hybrid smoke models' prefills under ``make_rules`` on a
    mesh (``ssm_cp`` on): the expert-parallel FFN and the
    context-parallel SSM block, logits within 1e-4 of the reference's;
    the hybrid prefill's SSM states are zero, as the reference's."""
    A, _ = ref
    cfg = get_smoke_config(arch).scaled(ssm_cp=True)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(_tree(A, f"route/{arch}/params"), cfg,
                               device="cpu")
    tokens = torch.from_numpy(A[f"route/{arch}/tokens"])
    mesh = _cpu_mesh(shape, ("data", "model"))
    with torch.no_grad(), use_rules(make_rules(mesh), mesh):
        logits, caches = model.prefill(params, {"tokens": tokens}, 16)
    diff = float(np.abs(logits.numpy() - A[f"route/{arch}/logits"]).max())
    assert diff < CP_TOL, diff
    if cfg.family == "hybrid":
        assert all(float(c.ssm.h.abs().max()) == 0.0 for c in caches)
