"""The port stands alone: nothing in ``src/repro_torch/`` or
``chip_smoke.py`` imports JAX or the reference package ``repro``."""
import ast
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_walk_finds_the_port():
    rel = {os.path.relpath(p, PORT) for p in _files()}
    assert "kernels/segment_reduce/kernel.py" in rel
    assert "core/mare.py" in rel
    assert "kernels/flash_attention/kernel.py" in rel
    assert "models/transformer.py" in rel
    assert "launch/serve.py" in rel
    assert "kernels/moe_dispatch/kernel.py" in rel
    assert "kernels/topk_reduce/kernel.py" in rel
    assert "models/moe.py" in rel
    assert "kernels/ssm_scan/kernel.py" in rel
    assert "kernels/ssm_scan/ops.py" in rel
    assert "models/ssm.py" in rel
    for mod in ("models/xlstm.py", "kernels/flash_attention/backward.py",
                "optim/adamw.py", "optim/adafactor.py", "train/step.py",
                "train/trainer.py", "checkpoint/manager.py",
                "launch/train.py"):
        assert mod in rel, mod
