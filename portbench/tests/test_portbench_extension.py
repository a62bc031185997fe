"""A later change adds a configuration, a cell, a traffic kind and a
per-layer metric as new files alone.

In a copy of ``portbench/`` and ``BENCHMARK.json``, the test drops in a
configuration, a traffic mix, its generator (the paper's Listing 1 GC
count) and a metric reader, adds their entries to the copy of
``BENCHMARK.json``, and runs the new cell on the CPU through the copied
harness in a process of its own: the harness lists the new cell and
metric and reports the metric, and no file the copy started with has
changed.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

NEW_FILES = {
    "configs/tiny-genome.json": json.dumps({
        "name": "tiny-genome", "source": "https://arxiv.org/abs/1808.02318",
        "bases": 30000, "line": 60, "num_shards": 4, "reduced": ["bases"],
        "reference": "portbench/kinds/gc_count.py"}),
    "traffic/gc.json": json.dumps({
        "kind": "gc_count", "warmup_actions": 1, "trace_actions": 1,
        "samples": 1}),
    "kinds/gc_count.py": '''
"""Traffic kind gc_count: the paper's Listing 1 over a loaded genome."""
import os
import tempfile

import numpy as np

from portbench.data import genome


class Session:
    cached_stages = 0

    def __init__(self, config, traffic, seed, device):
        from repro_torch.core import MaRe, TextFile
        from repro_torch.io import fasta_source
        self.seq = genome.make_genome(config["bases"], seed)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "g.fa")
            genome.write_fasta(path, self.seq, config["line"])
            self.ds = MaRe.from_source(
                fasta_source(path), num_shards=config["num_shards"],
                device=device).dataset
        self.mare, self.text = MaRe, TextFile

    def action(self):
        t = self.text
        m = (self.mare(self.ds)
             .map(input_mount=t("/dna"), output_mount=t("/count"),
                  image="ubuntu", command="grep-chars GC")
             .reduce(input_mount=t("/counts"), output_mount=t("/sum"),
                     image="ubuntu", command="awk-sum"))
        return m.collect(shard=0), m.report()

    def free(self):
        self.ds = None

    def check(self, answers):
        want = int(np.count_nonzero((self.seq == ord("G"))
                                    | (self.seq == ord("C"))))
        wrong = max(abs(int(a[0][0]) - want) for a in answers)
        return {"gc_wrong": (wrong, 0)}, {}


def setup(config, traffic, seed, device):
    return Session(config, traffic, seed, device)


def control(session, actions):
    return [(np.zeros(1, np.int64),)]
''',
    "metrics/cache_lookup_ms.py": '''
"""Per layer, runtime: the mean of the cache_lookup phase."""
KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "runtime"
MOVES = "action_s"


def read(run):
    got = [r["phases"]["cache_lookup"] for r in run.reports
           if "cache_lookup" in r["phases"]]
    return 1e3 * sum(got) / len(got) if got else None
''',
}

RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench import harness
bench = harness.benchmark()
print(json.dumps({
    "cells": harness.cells(bench),
    "per_layer": sorted(harness.metric_readers("per_layer")),
    "line": harness.run_cell("gc.count", 2 ** 31 + 3, 0.05, True, "cpu")}))
"""


def digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    bench_dir = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p.relative_to(tmp_path): digest(p)
              for p in tmp_path.rglob("*") if p.is_file()}

    for rel, text in NEW_FILES.items():
        path = bench_dir / rel
        assert not path.exists(), rel
        path.write_text(text)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny-genome", "source": "https://arxiv.org/abs/1808.02318",
        "file": "portbench/configs/tiny-genome.json", "reduced": ["bases"],
        "why": "Listing 1 on a tiny genome"})
    bench["workloads"].append({
        "name": "gc.count", "config": "tiny-genome", "traffic": "gc",
        "chips": 1, "why": "the GC count, no keyed fold"})
    bench["per_layer"].append({
        "name": "cache_lookup_ms", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "runtime", "moves": "action_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    done = subprocess.run([sys.executable, "-c", RUN, str(tmp_path)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert "gc.count" in got["cells"]
    assert "cache_lookup_ms" in got["per_layer"]
    line = got["line"]
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["gc_wrong"] == {"value": 0, "limit": 0}
    assert "cache_lookup_ms" in line["metrics"]

    for rel, want in before.items():
        if rel.name != "BENCHMARK.json":
            assert digest(tmp_path / rel) == want, rel
