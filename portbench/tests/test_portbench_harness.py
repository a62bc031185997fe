"""The harness on the CPU: its arguments, its refusal without a card, the
shape of its result line, the sample of answers, the trace's reduction,
and ``BENCHMARK.json`` against the files it names."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import devtrace, harness, run

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

#: Each cell at a size the CPU runs in seconds.
SMALL = {
    "kmer12.collect": {"config": {"bases": 20_000},
                       "traffic": {"k": 6, "warmup_actions": 1,
                                   "trace_actions": 1}},
    "snp.call": {"config": {"reads": 4096},
                 "traffic": {"warmup_actions": 1, "trace_actions": 1}},
}


def test_parse():
    args = run.parse(["--workload", "snp.call", "--seed", "2147483659",
                      "--seconds", "40", "--trace", "1"])
    assert (args.workload, args.seed, args.seconds, args.trace) == \
        ("snp.call", 2147483659, 40.0, 1)
    assert run.parse(["--workload", "x", "--seed", "1",
                      "--seconds", "1"]).trace == 0


@pytest.mark.parametrize("argv", [
    ["--seed", "1", "--seconds", "1"],
    ["--workload", "x", "--seed", "-1", "--seconds", "1"],
    ["--workload", "x", "--seed", "1", "--seconds", "0"],
    ["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"],
])
def test_parse_refuses(argv):
    with pytest.raises(SystemExit):
        run.parse(argv)


def test_no_card_no_result(capsys, monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH"):
        monkeypatch.delenv(var, raising=False)
    rc = run.main(["--workload", "kmer12.collect", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_unknown_workload(capsys):
    assert run.main(["--workload", "nope", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_cache_dirs_inside_checkout(monkeypatch, tmp_path):
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH"):
        monkeypatch.delenv(var, raising=False)
    run.cache_dirs()
    import os
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH"):
        assert os.environ[var].startswith(str(tmp_path / "build"))


def test_sampler_keeps_k_and_the_last():
    s = harness.Sampler(2, seed=3)
    for i in range(100):
        s.offer(i)
    got = s.answers()
    assert len(got) == 3 and got[-1] == 99
    again = harness.Sampler(2, seed=3)
    for i in range(100):
        again.offer(i)
    assert again.answers() == got
    few = harness.Sampler(2, seed=3)
    few.offer("a")
    assert few.answers() == ["a"]


def test_union_and_gaps():
    dev = [(0.0, 1.0, "k1"), (0.5, 2.0, "k2"), (3.0, 4.0, "k1")]
    assert devtrace.union(dev) == [(0.0, 2.0), (3.0, 4.0)]
    host = [(0.0, 10.0, devtrace.WINDOW), (0.0, 5.0, devtrace.ACTION),
            (2.1, 2.9, "cudaStreamSynchronize"), (5.5, 6.0, "aten::x")]
    gaps = devtrace.label_gaps([(2.0, 3.0), (4.0, 5.0), (5.0, 8.0)], host)
    assert [g[2] for g in gaps] == ["cudaStreamSynchronize", "host python",
                                    "between actions"]
    t = devtrace.DeviceTrace(actions=1, window_s=10.0, busy_s=3.0,
                             device=dev, gaps=gaps)
    assert t.breakdown()["device_ops"] == [["k1", 2.0], ["k2", 1.5]]
    assert t.seconds(lambda n: n == "k1") == 2.0


def test_bare_kernel_name():
    assert devtrace.bare_name(
        "void (anonymous namespace)::segsum_fold<int, 1>(int const*, int)"
    ) == "segsum_fold"
    assert devtrace.bare_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"


RUNS = """
import json, sys
sys.path.insert(0, sys.argv[1])
import pytest
from portbench import harness
from portbench.tests import test_portbench_faults as faults
from portbench.tests.test_portbench_harness import SMALL
out = []
for cell, trace, fault in json.loads(sys.argv[2]):
    with pytest.MonkeyPatch.context() as mp:
        if fault:
            faults.plant(mp, fault)
        out.append(harness.run_cell(cell, 2 ** 31 + 11, 0.05, trace, "cpu",
                                    overrides=SMALL[cell]))
print(json.dumps(out))
"""


def cpu_runs(jobs: list) -> list:
    """The result lines of ``jobs`` (cell, trace, planted fault or None),
    run on the CPU at ``SMALL`` sizes in a process of their own, on one
    thread: a run's threads and allocations stay out of the test process
    and its load off the other test workers."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    done = subprocess.run([sys.executable, "-c", RUNS, str(ROOT),
                           json.dumps(jobs)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def lines():
    """One traced and one untraced run of every cell on the CPU."""
    jobs = [(cell, trace, None) for cell in SMALL for trace in (False, True)]
    return {(cell, trace): line
            for (cell, trace, _), line in zip(jobs, cpu_runs(jobs))}


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(lines, cell, trace):
    line = lines[cell, trace]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    json.dumps(line)
    bench = harness.benchmark()
    if trace:
        want = {m["name"] for m in bench["per_layer"]
                if cell in m.get("workloads", [cell])}
        # the CPU has no device timeline: those metrics stay out
        want -= {"device_idle_share", "keyed_fold_roofline"}
        assert "busy_s" in line["device"] and "breakdown" in line
    else:
        want = {m["name"] for m in bench["end_to_end"]} - {"peak_alloc_gib"}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0


def entries(bench):
    return [*bench["end_to_end"], *bench["per_layer"]]


def test_benchmark_json_names_and_files():
    bench = harness.benchmark()
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert (ROOT / cfg["reference"]).is_file()
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        traffic = json.loads((ROOT / "portbench" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "kinds"
                / f"{traffic['kind']}.py").is_file()
    assert {w["config"] for w in bench["workloads"]} == configs


def test_metric_files_match_benchmark_json():
    bench = harness.benchmark()
    e2e = harness.metric_readers("end_to_end")
    per_layer = harness.metric_readers("per_layer")
    assert set(e2e) == {m["name"] for m in bench["end_to_end"]}
    assert set(per_layer) == {m["name"] for m in bench["per_layer"]}
    for m in entries(bench):
        mod = {**e2e, **per_layer}[m["name"]]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == \
            (m["unit"], m["better"], m["source"])
    for m in bench["per_layer"]:
        mod = per_layer[m["name"]]
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert m["moves"] in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
