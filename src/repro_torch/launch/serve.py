"""Serving entry point of the port: the batched token-decode smoke.

``--model-smoke`` prefills a batch of random prompts and greedy-decodes N
tokens, printing the reference's three lines (prefill ms, decode
ms/token, generated tokens):

    PYTHONPATH=src python -m repro_torch.launch.serve --model-smoke \\
        --arch llama3.2-1b --smoke --device cpu

It runs on ``cuda`` unless ``--device`` names another device; without a
GPU the default raises.  Weights are random, drawn from ``--seed``.  The
reference's other mode, ``--service`` (the multi-tenant query service),
is not ported yet and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Optional

import numpy as np
import torch

#: Where the multi-tenant service mode is ported (ROADMAP.md).
SERVICE_ITEM = "ROADMAP Queue 1, item 15 (serve/ and --service)"


@dataclasses.dataclass
class SmokeRun:
    """What one ``--model-smoke`` run produced, for callers that check it."""
    model: Any                  # repro_torch.models.Model
    params: Any                 # the LM module
    prompt: torch.Tensor        # [B, prompt_len] int64
    logits: torch.Tensor        # prefill logits [B, prompt_len, V]
    cache: Any                  # after the last decode step: a StackedKV
    #                             (dense, MoE) or a list of LayerCache
    #                             (hybrid)
    generated: np.ndarray       # [B, gen] greedy tokens
    prefill_s: float
    decode_s_per_token: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_smoke(args: argparse.Namespace,
                params: Optional[Any] = None) -> SmokeRun:
    """Prefill ``args.batch`` random prompts of ``args.prompt_len`` tokens,
    then greedy-decode ``args.gen`` tokens.  ``params`` (the LM module)
    replaces the seeded random weights when given."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    model = build_model(cfg, device=args.device)
    dev = model.device
    with torch.no_grad():
        if params is None:
            params = model.init(args.seed)
        rng = np.random.default_rng(args.seed)
        max_len = args.prompt_len + args.gen
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)

        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompt}, max_len)
        _sync(dev)
        t_pre = time.perf_counter() - t0
        tok = torch.argmax(logits[:, -1], dim=-1)
        out_tokens = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            lg, cache = model.decode_step(params, cache, tok)
            tok = torch.argmax(lg, dim=-1)
            out_tokens.append(tok)
        _sync(dev)
        t_dec = time.perf_counter() - t0
    generated = torch.stack(out_tokens, dim=1).cpu().numpy()
    return SmokeRun(model=model, params=params, prompt=prompt,
                    logits=logits, cache=cache, generated=generated,
                    prefill_s=t_pre,
                    decode_s_per_token=t_dec / max(args.gen - 1, 1))


def report_lines(args: argparse.Namespace, run: SmokeRun) -> list:
    """The reference's three result lines."""
    return [f"prefill: {run.prefill_s*1e3:.1f} ms for "
            f"{args.batch}x{args.prompt_len}",
            f"decode:  {run.decode_s_per_token*1e3:.2f} ms/token "
            f"(batch {args.batch})",
            f"generated: {run.generated[:2].tolist()}"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--service", action="store_true",
                      help="multi-tenant query service (not ported yet)")
    mode.add_argument("--model-smoke", action="store_true",
                      help="batched token-decode smoke")
    ap.add_argument("--arch")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.service:
        print(f"--service is not ported yet: {SERVICE_ITEM}",
              file=sys.stderr)
        return 2
    if args.arch is None:
        print("--model-smoke requires --arch", file=sys.stderr)
        return 2
    for line in report_lines(args, model_smoke(args)):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
