"""The ``lm_request`` kind at a tiny size on the CPU, and its control.

In a process of its own, the harness runs ``jamba.prompt64k`` with its
configuration cut to tiny widths in float32 (every layer kind and the
period kept) and a 40-token prompt: the line is ``correct``, carries the
new per-layer metrics ``prefill_ms`` and ``decode_step_ms`` (no
``ssm_scan_roofline`` without a card) and the runtime's, and the program
leaves no token dropped.  Then ``controls.readings`` at the same size with
float32 limits: the program passes and the control (the reference in
bfloat16, its scan state too) fails.  On the card, ``-m gpu``: the same
at the cell's widths with a 1,024-token prompt and the float8 control,
under the cell's own limits.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

TINY = {"config": {"hidden_size": 64, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "intermediate_size": 96,
                   "num_experts": 4, "mamba_d_state": 8,
                   "mamba_dt_rank": 8, "vocab_size": 256,
                   "dtype": "float32"},
        "traffic": {"prompt_tokens": 40, "decode_tokens": 3,
                    "warmup_actions": 1, "trace_actions": 1, "samples": 1}}
#: float32 on both sides: rounding alone, ~1e-6 measured; the share of
#: routing choices that differ is the cell's own limit
F32_LIMITS = {"logits_rel_rms": 1e-4, "logits_max_abs": 1e-4,
              "routing_flip_share": 3.0}

RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench import harness
over = json.loads(sys.argv[2])
print(json.dumps(harness.run_cell("jamba.prompt64k", 2 ** 31 + 7, 0.3,
                                  True, "cpu", overrides=over)))
"""


def test_tiny_cell_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    done = subprocess.run([sys.executable, "-c", RUN, str(ROOT),
                           json.dumps(TINY)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"]["moe_dropped"] == {"value": 0, "limit": 0}
    assert line["checks"]["logits_rel_rms"]["value"] < 1e-5
    for name in ("prefill_ms", "decode_step_ms", "dispatch_ms",
                 "device_wait_ms", "collect_ms"):
        assert name in line["metrics"], name
    assert "ssm_scan_roofline" not in line["metrics"]


def over(rec) -> list:
    return [k for k, v in rec["checks"].items() if v > rec["limits"][k]]


def readings(device, overrides, seed=2 ** 31 + 23):
    from portbench import controls
    recs = list(controls.readings("jamba.prompt64k", [seed], [seed], 1,
                                  device, overrides))
    return {r["side"]: r for r in recs}


def test_control_fails_where_the_program_passes():
    tiny = {"config": TINY["config"],
            "traffic": dict(TINY["traffic"], limits=F32_LIMITS)}
    by_side = readings("cpu", tiny)
    assert over(by_side["program"]) == [], by_side["program"]
    assert over(by_side["control"]) != [], by_side["control"]


@pytest.mark.gpu
def test_cell_widths_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the float8 control: at a 1,024-token prompt the bfloat16 one's
    # error need not reach the 64k cell's limits
    by_side = readings("cuda", {"traffic": {"prompt_tokens": 1024,
                                            "control": "fp8"}})
    assert over(by_side["program"]) == [], by_side["program"]
    assert over(by_side["control"]) != [], by_side["control"]
