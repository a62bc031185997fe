#!/usr/bin/env python3
"""The SNP-calling scores on each device, run after run, against numpy.

    python3 tools/torch_snp_repeat.py [--reps 10]

Runs the paper's Listing 3 action (``chip_smoke.snp_calling``) on the
read library of ``chip_smoke.make_library(READS, SEED)`` in SHARDS
shards, ``--reps`` times on each device in turns (cpu, cuda, cpu, ...),
and the surrogate aligner alone (``chip_smoke.bwa_align`` over the whole
library, no action) once a round on each, each against the numpy oracle
of the same formulas (``chip_smoke.snp_oracle``).  Every run prints its
largest score error, how many scores lie past TOL, its first three
scores, and for the reads past TOL their input shard (read id //
shard size), chromosome and place in the output; whether the library's
bytes are unchanged; and the process's float settings (TF32 switches,
matmul precision, CPU capability, threads).  The inputs and limit are
``tests/test_torch_kernels_gpu.py::test_snp_calling_on_cuda_equals_cpu``'s.
Prints the card's name and power limit.  Exits 1 if any run
misses the oracle, 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

READS, SEED, SHARDS, TOL = 50000, 4, 8, 1e-5


def float_settings() -> dict:
    """The switches that decide how a float32 product is taken here."""
    import torch
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "cpu_capability": torch.backends.cpu.get_cpu_capability(),
           "threads": torch.get_num_threads(),
           "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision(),
           "mkldnn": torch.backends.mkldnn.is_available(),
           "mkl": torch.backends.mkl.is_available()}
    for name, obj in (("fp32_precision", torch.backends),
                      ("cuda.matmul.fp32_precision",
                       torch.backends.cuda.matmul),
                      ("mkldnn.matmul.fp32_precision",
                       torch.backends.mkldnn.matmul
                       if hasattr(torch.backends.mkldnn, "matmul") else None)):
        if obj is not None and hasattr(obj, "fp32_precision"):
            out[name] = obj.fp32_precision
    return out


def compare(tag: str, score, ids, chrom, o_score, o_chrom,
            cap: int) -> dict:
    """One run's scores and chromosomes against the oracle's."""
    import numpy as np
    err = np.abs(score - o_score[ids])
    bad = np.flatnonzero(err > TOL)
    rec = {"run": tag, "max_abs_err": float(err.max()),
           "past_tol": int(bad.size), "n": int(ids.size),
           "first_scores": [float(x) for x in score[:3]],
           "chromosome_differences": int((chrom != o_chrom[ids]).sum())}
    if bad.size:
        rec.update(
            bad_input_shards=np.bincount(ids[bad] // cap).tolist(),
            bad_chromosomes=np.bincount(chrom[bad]).tolist(),
            bad_positions_first_last=[int(bad[0]), int(bad[-1])],
            bad_first=[[int(ids[i]), float(score[i]),
                        float(o_score[ids[i]])] for i in bad[:5]])
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_snp_repeat: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}")
    print("settings: " + json.dumps(float_settings()), flush=True)
    library = cs.make_library(READS, SEED)
    digest = hashlib.sha256(library[0].tobytes()).hexdigest()
    o_chrom, o_score, _ = cs.snp_oracle(library[0])
    cap = -(-READS // SHARDS)
    ids_all = np.arange(READS)
    misses = 0
    for rep in range(args.reps):
        for dev in ("cpu", "cuda"):
            chain = cs.snp_calling(library, SHARDS, dev)
            chrom, score, ids = chain.collect(shard=0)
            rec = compare(f"action {dev} {rep}", score, ids, chrom, o_score,
                          o_chrom, cap)
            drops = chain.report().diagnostics
            misses += bool(rec["past_tol"] or rec["chromosome_differences"]
                           or set(drops.values()) != {0})
            with torch.no_grad():
                c, s = cs.bwa_align(torch.from_numpy(library[0]).to(dev))
            rec = compare(f"bwa_align {dev} {rep}", s.cpu().numpy(), ids_all,
                          c.cpu().numpy(), o_score, o_chrom, cap)
            misses += bool(rec["past_tol"] or rec["chromosome_differences"])
            if hashlib.sha256(library[0].tobytes()).hexdigest() != digest:
                print(f"the library changed during {dev} run {rep}")
                misses += 1
                digest = hashlib.sha256(library[0].tobytes()).hexdigest()
    print("settings after: " + json.dumps(float_settings()))
    print(json.dumps({"runs": 4 * args.reps, "missed": misses,
                      "tol": TOL}))
    print(f"card: {smi}")
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
