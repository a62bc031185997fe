"""The whole slice at 8 shards, bit-identical to the reference.

The reference needs 8 devices, so it runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the way
``tests/test_distributed.py`` runs its scripts) and writes its ingested
dataset and per-shard outputs to an ``.npz``; the port runs here with
``num_shards=8`` over every pipeline of ``test_torch_mare.PIPELINES``.
Per-shard records, counts, ``describe()`` strings and counter
diagnostics must be identical.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np

import repro_torch.core as T
from repro_torch.io import fasta_source as port_fasta_source
from test_torch_mare import PIPELINES, _assert_identical, _genome, _leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["REPRO_SEGMENT_AUTOTUNE"] = "0"
    import jax
    import numpy as np
    import repro.core as R
    from repro.core.dataset import collect_shard
    from repro.io import fasta_source
    sys.path.insert(0, sys.argv[3])
    import test_torch_mare as t
    path, out = sys.argv[1], sys.argv[2]
    arrays, meta = {}, {}
    base = R.MaRe.from_source(fasta_source(path, split_bytes=1 << 11))
    ds = base.dataset
    arrays["input/data"] = np.asarray(jax.device_get(ds.records["data"]))
    arrays["input/len"] = np.asarray(jax.device_get(ds.records["len"]))
    arrays["input/counts"] = np.asarray(jax.device_get(ds.counts))
    for name, build in t.PIPELINES.items():
        m = build(R.MaRe(ds, plan_cache=R.PlanCache()), R)
        meta[name] = {"describe": m.describe()}
        done = m.dataset
        meta[name]["diagnostics"] = m.report().diagnostics
        for s in range(8):
            for i, leaf in enumerate(jax.tree.leaves(collect_shard(done, s))):
                arrays[f"{name}/{s}/{i}"] = np.asarray(leaf)
    np.savez(out, **arrays)
    with open(out + ".json", "w") as f:
        json.dump(meta, f)
    print("OK")
""")


def test_eight_shards_bit_identical_to_reference(tmp_path):
    path = _genome(tmp_path, n_lines=400, seed=7)
    out = str(tmp_path / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, path, out,
         os.path.dirname(os.path.abspath(__file__))],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-4000:]
    ref = np.load(out)
    meta = json.load(open(out + ".json"))

    base = T.MaRe.from_source(port_fasta_source(path, split_bytes=1 << 11),
                              num_shards=8, device="cpu")
    ds = base.dataset
    for key, leaf in (("data", ds.records["data"]),
                      ("len", ds.records["len"]), ("counts", ds.counts)):
        _assert_identical([ref[f"input/{key}"]], [leaf.numpy()])
    for name, build in PIPELINES.items():
        m = build(T.MaRe(ds, plan_cache=T.PlanCache()), T)
        assert m.describe() == meta[name]["describe"], name
        done = m.dataset
        assert m.report().diagnostics == meta[name]["diagnostics"], name
        for s in range(8):
            got = _leaves(T.collect_shard(done, s))
            want = [ref[f"{name}/{s}/{i}"] for i in range(len(got))]
            _assert_identical(want, got)
