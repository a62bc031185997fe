"""The port's serving entry, ``repro_torch.launch.serve --model-smoke``,
against the reference's on the same weights: at smoke size (float32) the
greedy tokens are equal."""
import ast

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as R_smoke_config
from repro.launch import serve as R_serve
from repro.models import build_model as R_build_model
from repro_torch.configs import get_smoke_config as T_smoke_config
from repro_torch.launch import serve as T_serve
from repro_torch.models.convert import params_from_numpy

ARCH = "llama3.2-1b"
ARGV = ["--model-smoke", "--arch", ARCH, "--smoke", "--batch", "3",
        "--prompt-len", "10", "--gen", "6", "--seed", "4"]


def test_greedy_tokens_match_reference(capsys):
    assert R_serve.main(ARGV) == 0
    ref_out = capsys.readouterr().out.splitlines()
    # the reference's entry draws its weights from PRNGKey(seed): carry
    # the same ones across
    params = R_build_model(R_smoke_config(ARCH)).init(
        jax.random.PRNGKey(4))
    args = T_serve.parse_args(ARGV + ["--device", "cpu"])
    run = T_serve.model_smoke(args, params=params_from_numpy(
        jax.tree.map(np.asarray, params), T_smoke_config(ARCH),
        device="cpu"))
    assert run.generated.shape == (3, 6)
    assert ref_out[2] == f"generated: {run.generated[:2].tolist()}"
    # the full batch, through the reference's model directly
    assert run.prompt.shape == (3, 10) and run.prompt.dtype == torch.int64
    m = R_build_model(R_smoke_config(ARCH))
    logits, cache = m.prefill(params, {"tokens": run.prompt.numpy()}, 16)
    tok = np.argmax(np.asarray(logits[:, -1]), -1)
    want = [tok]
    for _ in range(5):
        lg, cache = m.decode_step(params, cache, tok)
        tok = np.argmax(np.asarray(lg), -1)
        want.append(tok)
    np.testing.assert_array_equal(run.generated, np.stack(want, 1))
    assert run.cache.pos == 15


def test_cli_prints_the_reference_lines(capsys):
    assert T_serve.main(ARGV + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    assert out[0].startswith("prefill: ") and out[0].endswith(" ms for 3x10")
    assert out[1].startswith("decode: ") and "ms/token (batch 3)" in out[1]
    gen = ast.literal_eval(out[2][len("generated: "):])
    assert np.asarray(gen).shape == (2, 6)


def test_service_mode_is_not_ported_yet(capsys):
    """Kept under its old name: ``--service`` is ported now, so the mode
    runs the query-service loop (on the CPU here) and exits 0."""
    assert T_serve.main(["--service", "--device", "cpu", "--tenants", "1",
                         "--rounds", "1", "--reads", "64"]) == 0
    out = capsys.readouterr().out
    assert "served 1 actions" in out and "tenant_budget_violations=0" in out


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T_serve.main(ARGV)
