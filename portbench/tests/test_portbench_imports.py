"""The import boundary of the benchmark.

Nothing under ``portbench/`` imports JAX or the JAX package ``repro``;
the yardstick (``reference/``, ``work/``) imports nothing of the port
either.  Names are compared by their top-level part, taken whole before
the first dot, so ``repro_torch`` is not ``repro``.
"""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference", "work")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


def test_walks_every_module():
    rel = {p.relative_to(BENCH).as_posix() for p in MODULES}
    assert {"run.py", "harness.py", "reference/kmer.py",
            "work/keyed_fold.py"} <= rel


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.relative_to(BENCH).as_posix()
                              for p in MODULES])
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("part", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(part):
    for path in (BENCH / part).rglob("*.py"):
        assert "repro_torch" not in top_level_imports(path), path


def test_the_check_compares_whole_names(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import repro.core\nfrom jax import numpy\n"
                   "import repro_torch\n")
    assert top_level_imports(bad) & NEVER == {"repro", "jax"}
