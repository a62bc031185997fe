#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU, at full scale.

    python3 chip_smoke.py [--seed 0]

Drives the slices of ``repro_torch`` through their public entry
points.  First it builds the nine CUDA kernel libraries from
``src/repro_torch/csrc`` (the six forward kernels, the exchange and the
backwards of flash attention and the selective scan; one ``nvcc`` each,
started together).

Slice 1, the paper's pipeline, on a synthetic genome the size of GRCh38
chr21 (46,709,983 bases, FASTA with 60-base lines, ~1% of bases in N
runs), split into 8 logical shards:

1. hold the segment-sum kernels against their plain PyTorch version on
   the card, each case asserted on its route, at the shapes the k-mer path
   gives them (combiner and merge), on edge cases, one hot key, and rows
   too wide for the binned route's tiles (the atomic route);
2. GC count (the paper's Listing 1: ``grep-chars GC`` -> ``awk-sum``)
   against an exact numpy count;
3. k-mer statistics (``kmer-stats`` k=12 -> ``reduce_by_key`` sum) against
   a numpy ``bincount``, with every launch counter read around it: 16
   segment-sum calls (a combine and a merge a shard), all on the binned
   route; the first combine's and the first merge's inputs are kept;
4. on those real inputs, on a uniform stress merge and on one hot key,
   time the binned route and the atomic kernel it replaced in turns with
   CUDA events, beside the plain version, ``index_add_`` and the bound.

Slice 1b, the exchange (right after slice 1, on the same genome): the
exchange kernel on the k-mer action's own exchange inputs (8 sources of
4**12 rows, 3 leaves) and on the SNP action's over 8,388,608 reads (24
skewed keys), each captured around ``planner.shuffle_partition``: bit for
bit against the plain version, then both timed in turns with CUDA
events, the kernel's device time by kernel and its bound.

Slice 5, the interactive and out-of-core runtime, on the same genome
under an enabled tracer (it runs right after slice 1, which writes it):

a. the paper's interactive session: ``map(kmer-stats, k=12).persist()``,
   then five ``reduce_by_key`` sum queries from the device tier, each
   starting from the persisted map (one cached stage), launching the
   segment sum 16 times, with a table equal to numpy's bincount; the cold
   query (no persisted prefix) timed beside them;
b. the same query from the host tier: a cache whose device budget is
   below the persisted entry's estimated bytes spills it to CPU tensors,
   and the hit copies it back to the dataset's device;
c. three asynchronous queries, back in FIFO order with equal tables, each
   with its queue wait;
d. out of core: the GC count (``grep-chars GC`` -> ``awk-sum``) through
   ``io.WaveRunner`` in at least six waves of 8 splits (one a shard),
   equal to numpy's count and to the one-shot action's, with at most two
   programs built and a lower peak of allocated device memory than the
   one-shot action's; timed in turns with the same waves without the
   ingest lookahead (``prefetch=False``), each run's summed ``wave`` and
   ``wave.ingest`` spans beside its wall;
e. the exported Chrome trace holds the ``ingest``, ``wave``,
   ``wave.ingest``, ``cache.spill`` and ``cache.host_restore`` spans, and
   ``MaRe.metrics()`` counts the device-tier hits and every wave.

Slice 6, the segment-reduce tuner, streaming and the query service, on
the same genome under an enabled tracer (right after slice 5):

a. the segment-reduce dispatch at the k-mer action's combine and merge
   shapes: on the card a sum takes the kernel without measuring (the
   tuner times plain strategies on the CPU only); the action's wall with
   the static choice (``REPRO_SEGMENT_AUTOTUNE=0``) beside the default,
   every launch on the binned route;
b. the genome as 8 FASTA files of whole lines, dropped one at a time
   (``os.replace``) into an inbox under
   ``ContinuousSource(num_shards=8, device="cuda")``; an
   ``IncrementalQuery`` of the k-mer table, one ``update()`` a file:
   equal to numpy's table over the files so far after every epoch and to
   the one-shot action over all of them at the end, bit for bit, with
   one fold signature, 184 segment-sum launches (16 a delta action, 8 a
   fold), each epoch's ``update_s``, ``fold_s`` and allocated bytes;
c. a sliding ``WindowedQuery`` (size 3, slide 1) over the same files:
   every window equal to numpy's table over its epochs, 5 evicted
   partials gone from the cache;
d. the same stream through ``QueryService`` ->
   ``session("alice").stream(...)`` -> ``LiveQuery``: files dropped while
   ``follow()`` waits, each report the tenant's with its epoch;
e. ``launch.serve --service`` in process: 4 tenants x 6 rounds (sum,
   max, min) over 778,500 reads of 64 bases at k = 12: tables against
   numpy and the same plans outside the service, coalesced dispatches,
   16 segment-sum launches a sum group and 8 a max or min group (its
   merge's counts), QPS and p50 / p99.

The stream, window and live paths run on the default materialization
cache, whose device tier is a quarter of the card's memory.

Slice 2, LM serving at the full width of Llama-3.2-1B (16 layers,
d_model 2048, 32/8 heads, vocab 128256, bf16, random weights from the
seed):

5. hold the flash-attention and RMSNorm kernels against their plain
   versions on the card, at the prefill's shapes and on edge cases, and
   time kernel, plain version and one library call
   (``scaled_dot_product_attention``, ``rms_norm``) with CUDA events:
   flash's bf16 (wgmma) route at every served attention shape (Llama,
   granite, hymba windowed and global, and slices 2b and 2c's), each
   also held by relative RMS error and timed in turns with SDPA by
   CUDA-graph replay and back to back, its f32 (simt) route and the
   CUDA-core kernel on bf16 at Llama's; RMSNorm's one-pass path beside
   ``F.rms_norm`` and the two-pass loop, in turns;
6. ``repro_torch.launch.serve --model-smoke`` (batch 4, prompt 2048, 32
   greedy tokens) with every launch counter read around it: one flash
   launch per layer, all on the wgmma route;
7. the same prefill with plain attention, and teacher-forced decode
   against the forward pass, within stated bf16 tolerances;
8. RMSNorm's own route, ``models.layers.apply_rmsnorm(use_kernel=True)``,
   on the prefill's and a decode step's hidden-state shapes.

Slices 2b and 2c, vlm and encoder-decoder serving at the full width and
depth of internvl2-1b (24 layers, d_model 896, 14/2 heads, 256 patch
embeddings projected and prepended, vocab 151655) and whisper-base (6
encoder + 6 decoder layers, d_model 512, 8 heads, 1,500 frames, vocab
51865), bf16, random weights and inputs from the seed:

a. (in step 5) hold the flash kernel against its plain version on the
   wgmma route at their attention shapes, and time it: internvl2's
   causal prefill over 2,304 positions at GQA group 7, whisper's encoder
   over 1,500 frames (not causal; the last key tile holds 92 keys, and
   the check is shown to reject those tiles' zero-filled keys left in
   the softmax), and the teacher-forced forward's cross attention (448
   queries against the frames, not causal) and decoder self-attention
   (448, causal);
b. ``serve --model-smoke --arch internvl2-1b`` (batch 4, prompt 2048, 32
   greedy tokens): 24 flash launches in the request, all in the prefill
   at its attention shape;
   the same prefill with plain attention, teacher-forced decode against
   the forward pass;
c. ``serve --model-smoke --arch whisper-base`` (batch 4, prompt 416 and
   32 greedy tokens: the decoder's 448 positions): 6 flash launches in
   the prefill (the encoder; the decoder's prefill attention stays
   chunked and a decode step's cross attention plain, as the
   reference's), 0 in a decode step, 18 in the teacher-forced forward
   over all 448 tokens (6 at each of its three shapes); the same checks
   as b.

Slice 3a, MoE serving at the full width of granite-moe-1b-a400m (24
layers, d_model 1024, 16/8 heads, 32 experts top-8, expert d_ff 512,
vocab 49155, bf16, random weights from the seed):

9. hold the MoE-dispatch kernel against its plain version on the card,
   bit for bit, at a prefill's and a decode step's shapes and on edge
   cases, each asserted on its route (``cluster`` up to the cluster's
   reach of 131,072 ids over at most 1,024 groups, ``tiled`` past
   either); time the cluster route and the kernel it replaced (the
   tiled route) in turns, by CUDA-graph replay and back to back, at both
   shapes, beside the plain version and ``torch.sort(stable=True)`` +
   counts (``index_add_`` by graph replay, ``torch.bincount`` back to
   back);
10. ``serve --model-smoke`` at batch 4, prompt 2048, 32 greedy tokens: one
   dispatch launch per layer in the prefill and in every decode step, all
   on the cluster route, one flash launch per layer in the prefill;
11. the same prefill with the dispatch's plain version: the same
    positions and counts in every layer and the same logits; then
    teacher-forced decode against the forward pass.

Slice 3b, the paper's virtual-screening pipeline (Listing 2) over a
library of 2,097,152 molecules x 16 float32 features in 8 logical shards:

12. hold the top-k kernel against its plain version on the card, bit for
    bit, at a shard's shape (262,144 scores, k = 30), at the tree
    combines' sizes (``tree_reduce.split_factors(8, 2)`` groups of 30
    rows) and on edge cases, each asserted on its route (``select`` for
    k <= 32, ``tree`` past it); time the select route and the kernel
    it replaced (the tree route) in turns, by CUDA-graph replay and back to
    back, at a shard's and each tree combine's size, beside the plain
    version and ``torch.topk``;
13. ``map(tools/fred, rounds=8) -> reduce(toolbox/topk, k=30, depth=2) ->
    collect()``: one top-k launch per ``toolbox/topk`` combine, all on
    the select route, the 30 molecules equal to an oracle's over the
    whole library, the records equal to a plain top-k over the
    pipeline's own mapped scores, and the combines' sizes those timed.

Slice 3c, the paper's SNP-calling pipeline (Listing 3) over 2,097,152
reads x 16 float32 features (seed 3; ~6.7x coverage of chr21 at 150 bases
a read) in 8 logical shards: ``map(tools/bwa, rounds=4) ->
repartition_by(chromosome) -> map(tools/gatk) -> reduce(toolbox/concat,
depth=2) -> collect(shard=0)``, a hash exchange of 24 heavily skewed
chromosome keys over 8 shards, launching the exchange kernel once (the
``hash`` route) and no other kernel: the chromosomes,
read ids and variant count against a numpy oracle of the same formulas
over the whole library (a difference allowed only on reads within 1e-5
of an integer feature sum or 1e-4 of a zero score), the scores within
1e-4, the drop counter 0, every read once in the exchange with each
chromosome on one shard, and the records equal to gatk + concat over
the exchange's own shards; prints the per-shard counts after the
exchange and the action's phases.

Slice 4, hybrid serving at the full width and depth of hymba-1.5b (32
layers, d_model 1600, 25/5 heads, window 1024 on all but the global layers
0, 15 and 31, SSM state 16, vocab 32001, bf16, random weights from the
seed):

14. hold the selective-scan kernel against its plain version on the card
    at hymba's prefill and decode shapes, at the chunk's edges (T = L-1,
    L, L+1, 2048+17), on a long carried case and on edge cases (odd T, d
    not a multiple of the block, n of 2 to 16, two halves chained
    through h), each asserted on its route (``chunked``
    for T > 1, ``step`` for T = 1); time the chunked route against the
    serial kernel it replaced in turns, the step route by CUDA-graph
    replay and back to back, and the plain version; hold the flash kernel
    at hymba's GQA group 5 with window 1024 and without;
15. ``serve --model-smoke`` at batch 4, prompt 2048, 32 greedy tokens: one
    SSM launch per layer in the prefill (chunked route) and in every
    decode step (step route): 1,024 in the request, 32 chunked and 992
    step; one flash launch per layer in the prefill;
16. the same prefill with the reference's chunked scan in place of the
    kernel, and teacher-forced decode against the forward pass, each on an
    f32 copy of the weights and in bf16 (see ``SSM_ROUTE_TOL_FRAC``).

Slice 4b, the selective scan's dt route (the published Mamba-1 mixer's:
dt a channel, B and C given), then one stage of AI21-Jamba2-Mini at full
width (one period of 8 layers: one GQA attention layer without
positions, seven Mamba-1 layers, four 16-expert top-2 MoE layers, vocab
65536, bf16, random weights from the seed; 13,295,237,088 parameters):

14b. hold the dt route, with the mixer's gate in its epilogue, against
    its plain version on the card at Jamba's prefill (u and dt [1, 65536,
    8192] bf16, the plain version in blocks of steps chained through h)
    and decode-step shapes, at the chunk's edges and off the state
    sizes, each asserted on its route and as no launch of the fused
    route, the gated out within ``SSM_GATE_TOL_BF16`` (bf16) or
    ``SSM_TOL_FRAC`` and h within ``SSM_TOL_FRAC``; plant a fault (the
    carries between chunks dropped) that the out's limit rejects; time
    both routes by CUDA-graph replay and back to back beside the bound,
    the MUFU floor and the plain version; then the Mamba conv kernel
    against its plain version (within one ulp, the window bit for bit)
    and timed the same way at the prefill and decode shapes;
15b. the stage's prefill at batch 4, prompt 2048, then 31 greedy decode
    steps, every launch counter read around each: per prefill one flash
    launch, 4 dispatch launches and 7 dt-route and 7 conv launches, all
    chunked; per decode step 4 dispatch and 7 dt-route and 7 conv
    launches, all step; teacher-forced decode and the kept logits
    against the forward pass; then the benchmark cell's request twice
    (``serve.greedy_request``: 65,536 prompt tokens, 16 decode steps): 7
    chunked and 112 step dt-route and conv launches, 68 dispatch and 1
    flash launch each.

Slice 7, training at the full width and depth of Llama-3.2-1B (16
layers, d_model 2048, 32/8 heads, head dim 64, vocab 128256, bf16 params,
AdamW with f32 moments, remat on), through the flash-attention backward
kernel:

17. hold the backward kernel against its plain version taken in f32 on
    the same inputs, by relative RMS error of dq, dk and dv, each case
    asserted on its route: in f32 (``simt``) at every head dim, causal,
    windowed and not causal, GQA 1, 2 and 4, an Sk tail tile and rows
    without keys (zero dq); in bf16 (``wgmma``) not causal at D = 128,
    windowed, causal GQA 4 at D = 128 with an Sk tail, rows without keys
    and the training shape (q [4, 32, 2048, 64], k/v [4, 8, 2048, 64],
    causal), where SDPA's backward's error on the same inputs is printed
    beside; two launches give the same bytes; time it there by CUDA-graph
    replay in turns with the ``simt`` route's kernels, and back to back
    in turns with both and autograd of SDPA, beside the plain version,
    the bound (kept pairs x 10 D operations at the bf16 peak) and the
    two-pass design's floor (14 D), and the forward with and without its
    lse output;
18. ``launch/train.py``'s setup and trainer (the main path): 4 steps on
    one repeated batch of 4 x 2048 with a ``CheckpointManager`` in a
    temporary directory, saved at step 2: losses finite and falling,
    every leaf's gradient non-zero (every layer's wq/wk/wv), per step
    32 flash launches (the forward and remat's recompute) and 16
    backward launches, all wgmma, step ms and peak allocated bytes;
19. a fresh state restored from the step-2 checkpoint runs steps 3-4:
    its parameters and moments equal the uninterrupted run's bit for
    bit;
20. at full width and 2 layers in f32, one batch's gradients through
    the kernels against ``attn_impl="ref"``, leaf by leaf.

Slice 8, xlstm-1.3b serving at full width and depth (48 blocks in units
of 7 mLSTM + 1 sLSTM, d_model 2048, 4 heads, vocab 50304, bf16): ``serve
--model-smoke`` at batch 4, prompt 2048, 32 greedy tokens through
``prefill_ssm`` and the xlstm decode step, no kernel launch (the
reference has none for it); the sLSTM's sequential prefill is 6 x 2048
eager steps; the warm repeat and teacher-forced decode against the
forward pass.

Slice 9, training at the full width and depth of hymba-1.5b (the
hybrid family, bf16 params, AdamW, remat on, batch 4 x 2048), through the
selective scan's backward kernel:

21. hold the backward kernel against its plain version taken in f32 on
    the same inputs, by relative RMS error of each gradient, at the
    training shape in bf16 and f32 and at the edges (T = 1, 7, L-1, L,
    L+1, 300, two spans +- 1, 2048+17; d = 200 and 1001, no multiples of
    the kernel's channel group; n of 2 to 8; dt past softplus's
    threshold; a_log large enough that a underflows to 0; carried h0 and
    dh), two launches giving the same bytes; at the training shape hold
    it to the first design (the chunks re-run through device memory) and
    time both in turns by CUDA-graph replay, beside the plain version, its
    bound, both designs' MUFU floors, device time by kernel and one
    call's allocation (under ``SSM_BWD_CALL_BYTES``); hold the flash
    backward at hymba's two training shapes (GQA 5,
    window 1024 and global) and time it there by graph replay;
22. ``launch/train.py``'s setup and trainer (the main path): 3 steps on
    one repeated batch, no checkpoint: losses finite and falling, per
    step 64 SSM-scan launches on the chunked route (the forward and
    remat's recompute), 32 SSM backward launches on the scan route, 64
    flash and 32 flash
    backward launches, all wgmma, at hymba's two shapes; step ms and
    peak allocated bytes;
23. at full width and 2 layers (one global, one windowed) in f32, one
    batch's gradients through the kernels against the reference's
    chunked scan and ``attn_impl="ref"``, leaf by leaf.

Slice 10, the mesh: a mesh's shards on the one card, run one after
another (``core/collectives.py``), at full width, bf16, random weights:

24. hymba-1.5b's prefill at batch 4 x 2048 with ``ssm_cp`` under
    ``use_rules(make_rules(mesh), mesh)`` on (data 1, model 8): each SSM
    block context-parallel over eight sequence shards of 256, the scan
    kernel's chunked route launched twice a shard a layer (512 in all,
    against 32 for the plain prefill), zero SSM states returned; its
    logits held to the plain prefill's as the scan routes are (on an f32
    copy within 1% of the largest |logit|, in bf16 by relative RMS error
    against that f32 model); the warm walls of both in turns;
25. granite-moe-1b-a400m's prefill at batch 4 x 2048 on (data 2, model 4)
    (8 experts a shard, expert d_ff split 2 ways), in both layouts: at
    capacity factor 8 nothing drops and the logits lie within 10% of the
    largest |logit| of the dense path's (the dispatch kernel's); at the
    config's 1.25 the drops and the walls, in turns with the dense
    prefill; no dispatch kernel launch on this path;
26. Llama-3.2-1B through ``launch/train.py``'s setup (batch 4 x 2048):
    one AdamW step each of ``mare_tree`` at depths 1, 2 and 3 and at
    depth 2 with the int8 codec over (data 4), one sequence a shard, and
    of ``hierarchical`` over (pod 2, data 2), from the same state and
    batch as a fused step: flash and its backward launched once a shard
    a layer (twice forward, with remat), losses within 1e-3 of the fused
    step's, the gradients handed to AdamW leaf by leaf and their pre-clip
    norm held to the fused step's (the codec's to its plain version:
    each shard's gradients through the codec, summed in order), walls and
    peak allocated bytes; then the same on its 2-layer f32 copy at full
    width, where the gradients and norm are held within 1e-5 and every
    parameter within 1e-5 of the fused step that takes the four
    sequences one at a time, and of the whole-batch fused step's where
    its gradient is at or above 1e-6 (below, that step's one-at-a-time
    twin's distance is printed beside each sync's, as a witness);
27. slice 7's step-2 checkpoint restored through ``checkpoint.rescale``
    onto (data 2, model 2) with ``make_rules`` and the model's logical
    axes: every parameter bit-equal to the saved array; the restore's
    wall.

Slice 11, the dry run (``launch/dryrun_lib.py``: each cell's step
counted on the meta device by the work counter ``launch/hlo_cost.py``),
held to real steps:

28. on this machine's host, three cells on the production mesh (16 x
    16): Llama-3.2-1B x train_4k, hymba-1.5b x prefill_32k (its batch of
    32 does not divide 256 shards: ``ssm_cp``), granite-moe-1b-a400m x
    decode_32k (``token_gather``); each cell's compute, memory and
    collective terms over the H100's rates and its peak bytes;
29. one Llama-3.2-1B and one hymba-1.5b training step (slice 7 / 9's
    setup, 4 x 2048, AdamW, remat) and one granite prefill at the serving
    shape, each run once on the card under the counter (its launches read
    as slices 7, 9 and 3a read them) and once on meta: the FLOPs, the
    bytes and each kernel's reported operations equal as integers, every
    kernel's reports as many as its launches, and the arguments' bytes
    within 1% of those allocated for them; the meta peak beside
    ``max_memory_allocated()``, and the step's share of 989 TFLOP/s at
    slice 7 / 9's fastest warm step;
30. with tracing on, from a fresh plan cache, the k-mer action (a
    4,000,000-base genome, k = 12) and the VS action: each program's
    ``cost``, its counter's segment-sum / top-k reports as many as the
    launches, FLOPs and bytes above zero.

Slices run in the order 1, 1b, 5, 6, 2, 2b, 2c, 3a, 3b, 3c, 4, 4b, 7, 9,
8, 10, 11.
Every phase prints its wall time; the first failure exits non-zero.  A
served bf16 prefill whose flash launches leave the wgmma route fails, as
does a segment-sum launch off the binned route on the k-mer path, a
dispatch launch off the cluster route, a top-k launch off the select
route, a dt-route launch off the path's expected routes or an SSM
backward launch off the scan route on theirs.  Slice 10 prints
a ``[mesh]`` JSON line, slice 11 a ``[dryrun]`` one.  The last lines are
a JSON object describing the kernels (the backwards of flash attention and the selective scan
among them; every kernel's
``launches_by_path`` but RMSNorm's split by route; flash's
``served_shapes``, each with its launches by path as
counted by shape in this run; the segment sum's times of the real merge,
the stress merge and
the hot key beside its real combine's; the dispatch's and the top-k's
by graph replay and back to back beside the kernels they replaced),
the ``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.  Without
a CUDA device (or without the repository's ``src/`` beside it) the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

CHR21_BASES = 46_709_983       # GRCh38 chromosome 21, Ensembl release
LINE = 60                      # Ensembl FASTA line width
K = 12
NUM_SHARDS = 8
REPLACES = "src/repro/kernels/segment_reduce/kernel.py:105"
SOURCE = "src/repro_torch/csrc/segment_sum.cu"
ARCH = "llama3.2-1b"
BATCH, PROMPT, GEN = 4, 2048, 32


def phase(name: str, t0: float, extra: str = "") -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s"
          + (f"  {extra}" if extra else ""), flush=True)


def kernel_modules() -> dict:
    """The port's kernel modules by kernel name; each keeps a ``LAUNCHES``
    counter that its wrapper raises by one per kernel launch."""
    from repro_torch.kernels.flash_attention import backward as bmod
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.mamba_conv import kernel as cmod
    from repro_torch.kernels.moe_dispatch import kernel as dmod
    from repro_torch.kernels.rmsnorm import kernel as rmod
    from repro_torch.kernels.segment_reduce import kernel as kmod
    from repro_torch.kernels.ssm_scan import backward as sbmod
    from repro_torch.kernels.ssm_scan import kernel as smod
    from repro_torch.kernels.topk_reduce import kernel as tmod
    return {"segment_sum": kmod, "flash_attention": fmod, "rmsnorm": rmod,
            "moe_dispatch": dmod, "topk_reduce": tmod, "ssm_scan": smod,
            "flash_attention_bwd": bmod, "ssm_scan_bwd": sbmod,
            "mamba_conv": cmod}


def reset_launches() -> None:
    from repro_torch.kernels.exchange import kernel as xmod
    for mod in [*kernel_modules().values(), xmod]:
        mod.reset_launches()


#: Each main path's launch counts, read just after it ran with every
#: counter set to 0 just before it; flash's (forward and backward), the
#: SSM scan's (forward, its dt route and backward), the segment sum's, the dispatch's
#: and the top-k's also by route, flash's forward and backward also by
#: shape (see :func:`flash_shape`).
PATH_LAUNCHES: dict = {}
FLASH_ROUTES: dict = {}
FLASH_SHAPES: dict = {}
FLASH_BWD_ROUTES: dict = {}
FLASH_BWD_SHAPES: dict = {}
SSM_ROUTES: dict = {}
SSM_DT_ROUTES: dict = {}
CONV_ROUTES: dict = {}
SSM_BWD_ROUTES: dict = {}
SEGMENT_ROUTES: dict = {}
DISPATCH_ROUTES: dict = {}
TOPK_ROUTES: dict = {}
EXCHANGE_ROUTES: dict = {}


def read_launches(path: str, expect: dict, flash_route: str = "wgmma",
                  ssm_routes: Optional[dict] = None,
                  flash_shapes: Optional[dict] = None,
                  bwd_shapes: Optional[dict] = None,
                  dt_routes: Optional[dict] = None,
                  exchanges: Optional[dict] = None,
                  conv_routes: Optional[dict] = None) -> dict:
    """Every kernel's launches since :func:`reset_launches`, kept under
    ``path``; raises unless each kernel named in ``expect`` launched
    exactly that often and every other kernel not at all, unless every
    flash launch, forward and backward, took ``flash_route`` (a served
    bf16 prefill and a bf16 training step take ``"wgmma"``; only an f32
    copy of a model takes ``"simt"``), unless
    every segment-sum launch took the ``binned`` route, every dispatch
    launch the ``cluster`` route and every top-k launch the ``select``
    route, unless the SSM scan's launches split by route as
    ``ssm_routes`` says (none on any route when it is None), unless the
    scan's dt route (kernel ``ssm_scan_dt``, counted in the scan module's
    ``DT_LAUNCHES``) split by route as ``dt_routes`` says (none when it is
    None), unless the Mamba mixer's conv (kernel ``mamba_conv``) split by
    route as ``conv_routes`` says (none when it is None), unless every
    SSM backward launch took the ``scan`` route, and unless
    flash's launches split by shape as ``flash_shapes`` says and the flash
    backward's as ``bwd_shapes`` says, and the exchange's (kernel
    ``exchange``) by route as ``exchanges`` says, when they are given (the
    exchange's launches are kept, not checked, without ``exchanges``)."""
    from repro_torch.kernels.exchange import kernel as xmod
    mods = kernel_modules()
    got = {name: mod.LAUNCHES for name, mod in mods.items()}
    got["ssm_scan_dt"] = mods["ssm_scan"].DT_LAUNCHES
    got["exchange"] = xmod.LAUNCHES
    exch = dict(xmod.LAUNCHES_BY_ROUTE)
    routes = dict(mods["flash_attention"].LAUNCHES_BY_ROUTE)
    ssm = dict(mods["ssm_scan"].LAUNCHES_BY_ROUTE)
    ssm_dt = dict(mods["ssm_scan"].DT_LAUNCHES_BY_ROUTE)
    conv = dict(mods["mamba_conv"].LAUNCHES_BY_ROUTE)
    ssm_bwd = dict(mods["ssm_scan_bwd"].LAUNCHES_BY_ROUTE)
    seg = dict(mods["segment_sum"].LAUNCHES_BY_ROUTE)
    disp = dict(mods["moe_dispatch"].LAUNCHES_BY_ROUTE)
    topk = dict(mods["topk_reduce"].LAUNCHES_BY_ROUTE)
    shapes = dict(mods["flash_attention"].LAUNCHES_BY_SHAPE)
    bwd = dict(mods["flash_attention_bwd"].LAUNCHES_BY_ROUTE)
    bwd_by_shape = dict(mods["flash_attention_bwd"].LAUNCHES_BY_SHAPE)
    PATH_LAUNCHES[path] = got
    FLASH_BWD_ROUTES[path] = bwd
    FLASH_BWD_SHAPES[path] = bwd_by_shape
    FLASH_ROUTES[path] = routes
    FLASH_SHAPES[path] = shapes
    SSM_ROUTES[path] = ssm
    SSM_DT_ROUTES[path] = ssm_dt
    CONV_ROUTES[path] = conv
    SSM_BWD_ROUTES[path] = ssm_bwd
    SEGMENT_ROUTES[path] = seg
    DISPATCH_ROUTES[path] = disp
    TOPK_ROUTES[path] = topk
    EXCHANGE_ROUTES[path] = exch
    want = {name: expect.get(name, 0) for name in got}
    want["exchange"] = (got["exchange"] if exchanges is None
                        else sum(exchanges.values()))
    want_routes = {r: got["flash_attention"] * (r == flash_route)
                   for r in routes}
    want_bwd = {r: got["flash_attention_bwd"] * (r == flash_route)
                for r in bwd}
    want_ssm = {r: (ssm_routes or {}).get(r, 0) for r in ssm}
    want_dt = {r: (dt_routes or {}).get(r, 0) for r in ssm_dt}
    want_conv = {r: (conv_routes or {}).get(r, 0) for r in conv}
    want_ssm_bwd = {r: got["ssm_scan_bwd"] * (r == "scan") for r in ssm_bwd}
    want_seg = {r: got["segment_sum"] * (r == "binned") for r in seg}
    want_disp = {r: got["moe_dispatch"] * (r == "cluster") for r in disp}
    want_topk = {r: got["topk_reduce"] * (r == "select") for r in topk}
    if (got != want or routes != want_routes or bwd != want_bwd
            or ssm != want_ssm or ssm_dt != want_dt or conv != want_conv
            or ssm_bwd != want_ssm_bwd
            or seg != want_seg or disp != want_disp
            or topk != want_topk
            or exchanges not in (None, exch)
            or flash_shapes not in (None, shapes)
            or bwd_shapes not in (None, bwd_by_shape)):
        raise AssertionError(f"{path}: launches {got}, flash by route "
                             f"{routes}, flash backward by route {bwd}, "
                             f"ssm_scan by route {ssm}, ssm_scan_dt by "
                             f"route {ssm_dt}, mamba_conv by route "
                             f"{conv}, ssm_scan_bwd by "
                             f"route {ssm_bwd}, "
                             f"segment_sum by route {seg}, moe_dispatch "
                             f"by route {disp}, topk_reduce by route "
                             f"{topk}, exchange by route {exch}, flash by "
                             f"shape {shapes}, flash backward by shape "
                             f"{bwd_by_shape}; expected {want}, "
                             f"{want_routes}, {want_bwd}, {want_ssm}, "
                             f"{want_dt}, {want_conv}, {want_ssm_bwd}, "
                             f"{want_seg}, "
                             f"{want_disp}, {want_topk}, {exchanges}, "
                             f"{flash_shapes}, {bwd_shapes}")
    return got


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_genome(n: int, seed: int) -> np.ndarray:
    """Random ACGT bases with ~1% in N runs and ~5% soft-masked
    (lowercase) runs, as uint8 bytes."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    for code, frac in ((ord("N"), 0.01), (None, 0.05)):
        target = int(n * frac)
        while target > 0:
            length = min(int(rng.integers(1000, 20000)), target)
            start = int(rng.integers(0, n - length))
            if code is None:
                seq[start:start + length] |= 0x20      # to lowercase
            else:
                seq[start:start + length] = code
            target -= length
    return seq


def write_fasta(path: str, seq: np.ndarray) -> None:
    full = len(seq) // LINE
    body = np.empty((full, LINE + 1), np.uint8)
    body[:, :LINE] = seq[:full * LINE].reshape(full, LINE)
    body[:, LINE] = ord("\n")
    with open(path, "wb") as f:
        f.write(f">21 dna:chromosome chromosome:GRCh38:21:1:{len(seq)}:1 "
                f"REF\n".encode())
        f.write(body.tobytes())
        tail = seq[full * LINE:]
        if tail.size:
            f.write(tail.tobytes() + b"\n")


def kmer_bincount(seq: np.ndarray, k: int) -> np.ndarray:
    """Exact k-mer occurrence table of the FASTA's lines (k-mers do not
    span lines; windows with a non-ACGT base are skipped)."""
    n_lines = -(-len(seq) // LINE)
    lines = np.zeros((n_lines, LINE), np.uint8)
    lines.reshape(-1)[:len(seq)] = seq
    lens = np.full(n_lines, LINE)
    lens[-1] = len(seq) - (n_lines - 1) * LINE
    upper = np.where((lines >= 97) & (lines <= 122), lines - 32, lines)
    code = np.zeros(256, np.int64)
    ok = np.zeros(256, bool)
    for i, b in enumerate(b"ACGT"):
        code[b], ok[b] = i, True
    c, o = code[upper], ok[upper]
    nw = LINE - k + 1
    acc = np.zeros((n_lines, nw), np.int64)
    win = np.ones((n_lines, nw), bool)
    for j in range(k):
        acc = acc * 4 + c[:, j:j + nw]
        win &= o[:, j:j + nw]
    win &= (np.arange(nw)[None, :] + k) <= lens[:, None]
    return np.bincount(acc[win], minlength=4 ** k)


# ---------------------------------------------------------------------------
# kernel check and timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: Optional[int] = None, warmup: int = 3) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls.  ``reps`` defaults to 20, or
    to 200 for a call under 0.1 ms (one timed call decides), so that two
    short kernels are not told apart by noise."""
    import torch
    for _ in range(warmup):
        fn()
    if reps is None:
        reps = 200 if cuda_ms(fn, reps=1, warmup=0) < 0.1 else 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 200, replays: int = 5) -> float:
    """Device ms per call of ``fn``, replayed from a CUDA graph of
    ``reps`` calls: the host's launch cost is left out, as it must be for
    a latency-bound call (a decode step's few rows), whose back-to-back
    launches would time the host.  The median of ``replays`` timed
    replays: a call of a microsecond or two reads up to one more in a
    single replay now and then."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def in_turns(timer, fns) -> tuple:
    """ms of each of ``fns`` by ``timer``, taken in turns (0, 1, ..., 1,
    0) and averaged, so that a drift of the card's clock falls on all of
    them alike, after one untimed round (the first timing after other
    work can read a cold card); returns (the means, the single times in
    order)."""
    for fn in fns:
        timer(fn)
    order = list(range(len(fns))) + list(range(len(fns)))[::-1]
    t = [timer(fns[i]) for i in order]
    return [sum(v for i, v in zip(order, t) if i == k) / 2
            for k in range(len(fns))], t


def compare(name, kern, plain, atol: float = 0.0) -> float:
    """Max abs error between kernel and plain outputs; raises on
    disagreement.  Integer outputs must be equal.  A float32 table is
    held to the plain version taken in float64 with rtol 1e-5 and
    ``atol`` (tied to the inputs by the caller)."""
    import torch
    err = 0.0
    for a, b in zip(kern, plain):
        floats = a.dtype == torch.float32 and b.dtype == torch.float64
        if a.shape != b.shape or (a.dtype != b.dtype and not floats):
            raise AssertionError(f"{name}: {a.dtype}{tuple(a.shape)} vs "
                                 f"{b.dtype}{tuple(b.shape)}")
        if floats:
            if not torch.allclose(a.double(), b, rtol=1e-5, atol=atol):
                raise AssertionError(f"{name}: kernel !~ plain version")
        elif not torch.equal(a, b):
            raise AssertionError(f"{name}: kernel != plain version")
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def bound_ms(n: int, n_valid: int, d: int, num_keys: int) -> float:
    """Least time for the segment sum on these inputs
    (``repro_torch.kernels.work.segment_sum``: every valid flag read, the
    key and values of each valid record read once, each output byte
    written once, over HBM bandwidth; its adds take far less)."""
    from repro_torch.kernels import work
    return work.segment_sum(n, n_valid, d, num_keys).bound()[0]


def plain_and_library_ms(keys, vals, valid, num_keys):
    """ms of the plain version and of one ``index_add_`` call (the
    library yardstick: pre-masked sentinel keys, counts as an extra
    column), same inputs."""
    import torch
    from repro_torch.kernels.segment_reduce.ref import segment_sum_ref
    n, d = vals.shape
    plain = cuda_ms(lambda: segment_sum_ref(keys, vals, num_keys, valid))
    idx = torch.where(valid & (keys >= 0) & (keys < num_keys), keys,
                      num_keys).long()
    aug = torch.cat([vals, torch.ones((n, 1), dtype=vals.dtype,
                                      device=vals.device)], dim=1)
    table = torch.zeros((num_keys + 1, d + 1), dtype=vals.dtype,
                        device=vals.device)
    lib = cuda_ms(lambda: table.index_add_(0, idx, aug))
    return plain, lib


def time_kernel(keys, vals, valid, num_keys):
    """ms of the kernel wrapper, the plain version and ``index_add_``."""
    from repro_torch.kernels.segment_reduce.kernel import segment_sum
    ms = cuda_ms(lambda: segment_sum(keys, vals, num_keys, valid))
    return (ms, *plain_and_library_ms(keys, vals, valid, num_keys))


def segment_atomic(keys, vals, num_keys, valid):
    """The parent's segment sum (one thread a record, global atomics into
    outputs zero-filled first; the atomic route now) through its C entry,
    memsets included: timed beside the binned route in turns, never a
    route of the port's wrapper here, so it counts no launch."""
    import torch
    from repro_torch.kernels.build import check_launch
    from repro_torch.kernels.segment_reduce import kernel as kmod
    n, d = vals.shape
    dev = vals.device
    table = torch.zeros((num_keys, d), dtype=vals.dtype, device=dev)
    counts = torch.zeros((num_keys,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    entry = ("segment_sum_atomic_i32" if vals.dtype == torch.int32
             else "segment_sum_atomic_f32")
    err = getattr(kmod.LIBRARY.load(), entry)(
        keys.data_ptr(), vals.data_ptr(), valid.data_ptr(), n, d, num_keys,
        table.data_ptr(), counts.data_ptr(), overflow.data_ptr(), sms * 16,
        torch.cuda.current_stream().cuda_stream)
    check_launch("segment_sum (atomic)", err)
    return table, counts, overflow


def segment_check(name, got, keys, vals, valid, nk) -> tuple:
    """(max abs error, atol) of a segment sum's outputs against the plain
    version; raises on disagreement.  A float32 table is held to the plain
    version in float64 (the kernels add in another order): atol 1e-6 x
    the largest per-key count x the largest valid |value|."""
    import torch
    from repro_torch.kernels.segment_reduce.ref import segment_sum_ref
    if vals.dtype != torch.float32:
        return compare(name, got, segment_sum_ref(keys, vals, nk, valid)), 0.0
    want = segment_sum_ref(keys, vals.double(), nk, valid)
    vmax = float(vals[valid].abs().max()) if bool(valid.any()) else 0.0
    atol = 1e-6 * int(want[1].max()) * vmax
    return compare(name, got, want, atol), atol


def kernel_phase(ds, cap2: int) -> dict:
    """The segment-sum kernels against the plain version on the card, each
    case asserted on its route: the combiner's shape, a uniform merge,
    edge cases, one hot key, rows too wide for a tile (the atomic route);
    returns the errors by case."""
    import torch
    from repro_torch.core import images
    from repro_torch.kernels.segment_reduce import kernel as kmod
    seg = kmod.segment_sum
    dev = ds.device
    g = torch.Generator(device=dev).manual_seed(1)
    num_keys = 4 ** K
    # combiner input: the real kmer-stats output of shard 0
    part = images.kmer_stats(k=K)(ds.shard(0))
    ckeys, cones = part.records
    cvalid = part.mask()
    cvals = cones.reshape(-1, 1).contiguous()
    n_c = ckeys.shape[0]
    mkeys, mvals, mvalid = uniform_merge(dev, g, NUM_SHARDS * cap2)
    cases = [
        ("combiner", ckeys, cvals, cvalid, num_keys),
        ("merge d=2", mkeys, mvals, mvalid, num_keys),
        ("merge d=1", mkeys, mvals[:, :1].contiguous(), mvalid, num_keys),
    ]
    n_e = 1 << 20
    ekeys = torch.randint(-5, 1000008, (n_e,), device=dev,
                          dtype=torch.int32, generator=g)
    evals = torch.randint(-100, 100, (n_e, 3), device=dev,
                          dtype=torch.int32, generator=g)
    evalid = torch.rand(n_e, device=dev, generator=g) < 0.7
    fvals = torch.randn((n_e, 3), device=dev, generator=g)
    fvals[~evalid] = float("nan")      # padding may hold NaN
    wide = torch.randint(-100, 100, (n_e // 8, 100), device=dev,
                         dtype=torch.int32, generator=g)
    cases += [
        ("out-of-range keys, odd num_keys", ekeys, evals, evalid, 1000003),
        ("float32", ekeys, fvals, evalid, 1000003),
        ("all masked", ekeys, evals, torch.zeros_like(evalid), 1000003),
        ("one hot key", hot_keys(n_c, dev), cvals, cvalid, num_keys),
        ("one hot key, float32", hot_keys(n_c, dev), cvals.float(), cvalid,
         num_keys),
        ("rows of 100 (atomic route)", ekeys[:n_e // 8], wide,
         evalid[:n_e // 8], 1000003),
        ("rows of 100, float32 (atomic route)", ekeys[:n_e // 8],
         wide.float(), evalid[:n_e // 8], 1000003),
        ("n=0", ekeys[:0], evals[:0], evalid[:0], 1000003),
    ]
    errs = {}
    for name, keys, vals, valid, nk in cases:
        t0 = time.perf_counter()
        n, d = vals.shape
        kind = kmod.route(nk, d, n, dev)
        before = kmod.LAUNCHES, dict(kmod.LAUNCHES_BY_ROUTE)
        got = seg(keys, vals, nk, valid)
        torch.cuda.synchronize()
        errs[name], atol = segment_check(name, got, keys, vals, valid, nk)
        want = dict(before[1])
        if n:
            want[kind] += 1
        launched = kmod.LAUNCHES - before[0]
        if (launched, kmod.LAUNCHES_BY_ROUTE) != (int(n > 0), want):
            raise AssertionError(f"{name}: {launched} launches, by route "
                                 f"{kmod.LAUNCHES_BY_ROUTE}; expected "
                                 f"{int(n > 0)} on {kind}")
        phase(f"kernel check {name}", t0,
              f"n={n} d={d} num_keys={nk} route={kind} "
              f"max_abs_err={errs[name]} atol={atol} "
              f"overflow={int(got[2][0])}")
    return errs


def uniform_merge(dev, g, n: int):
    """A stress merge: n keys drawn uniformly over all 4**K keys, (value,
    count) columns, 95% valid."""
    import torch
    keys = torch.randint(0, 4 ** K, (n,), device=dev, dtype=torch.int32,
                         generator=g)
    vals = torch.randint(1, 50, (n, 2), device=dev, dtype=torch.int32,
                         generator=g)
    return keys, vals, torch.rand(n, device=dev, generator=g) < 0.95


def hot_keys(n: int, dev):
    import torch
    return torch.full((n,), 12345, device=dev, dtype=torch.int32)


def timing_phase(real: dict, ds, cap2: int, errs: dict) -> dict:
    """Time the binned route against the parent's atomic kernel in turns
    (binned, atomic, atomic, binned), with the plain version, one
    ``index_add_`` and the bytes bound, on the k-mer action's own first
    combine and first merge inputs (``real``, by d), on the uniform stress
    merge and on one hot key over the combine's records; returns the
    segment-sum JSON record (``ms`` etc. of the real combine)."""
    import torch
    from repro_torch.kernels.segment_reduce.kernel import segment_sum
    dev = ds.device
    g = torch.Generator(device=dev).manual_seed(2)
    ckeys, cvals, cvalid, nk = real[1]
    cases = {"real combine": real[1], "real merge": real[2],
             "stress merge": (*uniform_merge(dev, g, NUM_SHARDS * cap2), nk),
             "one hot key": (hot_keys(ckeys.shape[0], dev), cvals, cvalid,
                             nk)}
    out = {}
    for name, (keys, vals, valid, nk) in cases.items():
        t0 = time.perf_counter()
        n, d = vals.shape
        n_valid = int(valid.sum())
        errs[f"{name} (atomic)"] = segment_check(
            name, segment_atomic(keys, vals, nk, valid), keys, vals, valid,
            nk)[0]
        (binned, atomic), singles = in_turns(cuda_ms, [
            lambda: segment_sum(keys, vals, nk, valid),
            lambda: segment_atomic(keys, vals, nk, valid)])
        plain, lib = plain_and_library_ms(keys, vals, valid, nk)
        bnd = bound_ms(n, n_valid, d, nk)
        out[name] = dict(ms=binned, atomic_ms=atomic, plain_ms=plain,
                         library_ms=lib, bound_ms=bnd)
        turns = [round(t, 4) for t in singles]
        phase(f"kernel timing {name}", t0,
              f"n={n} d={d} num_keys={nk} valid={n_valid} "
              f"valid_share={n_valid / n:.4f} binned_ms={binned:.4f} "
              f"atomic_ms={atomic:.4f} in_turns={turns} plain_ms="
              f"{plain:.4f} index_add_ms={lib:.4f} bound_ms={bnd:.4f}")
    comb, merge = out["real combine"], out["real merge"]
    return {"name": "segment_sum", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": None,
            "max_abs_err": max(errs.values()), "ms": comb["ms"],
            "plain_ms": comb["plain_ms"], "bound_ms": comb["bound_ms"],
            "bound_by": "bytes", "library_ms": comb["library_ms"],
            "atomic_ms": comb["atomic_ms"], "merge_ms": merge["ms"],
            "merge_atomic_ms": merge["atomic_ms"],
            "merge_plain_ms": merge["plain_ms"],
            "merge_bound_ms": merge["bound_ms"],
            "merge_library_ms": merge["library_ms"],
            "stress_merge_ms": out["stress merge"]["ms"],
            "stress_merge_atomic_ms": out["stress merge"]["atomic_ms"],
            "hot_key_ms": out["one hot key"]["ms"],
            "hot_key_atomic_ms": out["one hot key"]["atomic_ms"]}


def capturing(fn, keep: dict, calls: list):
    """``fn`` (the segment sum) that also logs each call's d in ``calls``
    and keeps clones of the first call's inputs at each d in ``keep``."""
    def segment_sum(keys, values, num_keys, valid):
        d = values.shape[1]
        calls.append(d)
        if d not in keep:
            keep[d] = (keys.clone(), values.clone(), valid.clone(), num_keys)
        return fn(keys, values, num_keys, valid)
    return segment_sum


# ---------------------------------------------------------------------------
# slice 1: the paper's pipeline at chr21 scale
# ---------------------------------------------------------------------------


def kmer_slice(tmp: str, seed: int) -> tuple:
    """GC count and k-mer statistics on a chr21-sized genome written under
    ``tmp``; returns the segment-sum kernel's JSON record and the genome
    (``fasta`` path, ``seq`` bases, numpy k-mer ``table``) for the
    interactive and out-of-core paths."""
    import torch
    from repro_torch.core import MaRe, TextFile
    from repro_torch.core.shuffle import keyed_bucket_capacity
    from repro_torch.io import fasta_source
    from repro_torch.kernels.segment_reduce import kernel as kmod
    from repro_torch.kernels.segment_reduce import ops

    t0 = time.perf_counter()
    seq = make_genome(CHR21_BASES, seed)
    fasta = os.path.join(tmp, "chr21.fa")
    write_fasta(fasta, seq)
    phase("write genome", t0, f"bases={len(seq)} "
          f"N={int((seq == ord('N')).sum())} "
          f"bytes={os.path.getsize(fasta)}")

    t0 = time.perf_counter()
    src = fasta_source(fasta)
    ds = MaRe.from_source(src, num_shards=NUM_SHARDS).dataset
    torch.cuda.synchronize()
    phase("ingest", t0, f"shards={ds.num_shards} cap={ds.capacity} "
          f"width={ds.records['data'].shape[1]} "
          f"records={int(ds.counts.sum())} device={ds.device}")

    cap2 = keyed_bucket_capacity(4 ** K, NUM_SHARDS)
    errs = kernel_phase(ds, cap2)

    # GC count: the paper's Listing 1
    t0 = time.perf_counter()
    gc = (MaRe.from_source(src, num_shards=NUM_SHARDS)
          .map(input_mount=TextFile("/dna"),
               output_mount=TextFile("/count"),
               image="ubuntu", command="grep-chars GC")
          .reduce(input_mount=TextFile("/counts"),
                  output_mount=TextFile("/sum"),
                  image="ubuntu", command="awk-sum"))
    (total,) = gc.collect(shard=0)
    want = int(np.count_nonzero((seq == ord("G")) | (seq == ord("C"))))
    if int(total[0]) != want:
        raise AssertionError(f"GC count {int(total[0])} != numpy {want}")
    phase("GC count", t0, f"gc={int(total[0])} numpy={want} "
          f"phases={json.dumps(gc.report().phases)}")

    # k-mer statistics: the main path through the segment-sum kernel
    t0 = time.perf_counter()
    want_table = kmer_bincount(seq, K)
    phase("numpy k-mer reference", t0,
          f"windows={int(want_table.sum())} "
          f"distinct={int((want_table > 0).sum())}")
    # the action's own segment-sum inputs are kept (first combine,
    # d = 1; first merge, d = 2) for the timing phase
    t0 = time.perf_counter()
    real: dict = {}
    calls: list = []
    reset_launches()
    ops.segment_sum = capturing(kmod.segment_sum, real, calls)
    try:
        stats = (MaRe.from_source(src, num_shards=NUM_SHARDS)
                 .map(image="kmer-stats", command=f"kmer-stats {K}")
                 .reduce_by_key(lambda r: r[0],
                                value_by=lambda r: (r[1],), op="sum"))
        desc = stats.describe()
        keys, (occ,), cnt = stats.collect()
    finally:
        ops.segment_sum = kmod.segment_sum
    # one combine and one merge a shard; one exchange, keys hashed on the
    # card
    read_launches("kmer", {"segment_sum": 2 * NUM_SHARDS},
                  exchanges={"hash": 1, "dests": 0})
    if calls != [1] * NUM_SHARDS + [2] * NUM_SHARDS:
        raise AssertionError(f"k-mer segment-sum calls by d: {calls}")
    report = stats.report()
    print(desc, flush=True)
    phase("k-mer reduce_by_key", t0,
          f"keys={len(keys)} launches={kmod.LAUNCHES} "
          f"by_route={json.dumps(kmod.LAUNCHES_BY_ROUTE)} "
          f"action_wall_s={report.wall_s:.6f} "
          f"diagnostics={json.dumps(report.diagnostics)}")
    print("[report] phases " + json.dumps(report.phases), flush=True)
    t0 = time.perf_counter()
    out = stats.dataset
    on_cuda = all(leaf.is_cuda for leaf in
                  [out.counts, *out.records[:1], *out.records[1],
                   out.records[2]])
    if not on_cuda:
        raise AssertionError("k-mer result does not live on cuda")
    check_table("k-mer", (keys, (occ,), cnt), want_table)
    phase("k-mer check", t0, "table == numpy bincount, on cuda")
    record = timing_phase(real, ds, cap2, errs)
    record["launches"] = 2 * NUM_SHARDS
    shapes = {"combine": real[1][0].shape[0], "merge": real[2][0].shape[0]}
    return record, {"fasta": fasta, "seq": seq, "table": want_table,
                    "shapes": shapes}


# ---------------------------------------------------------------------------
# slice 1b: the exchange at the k-mer and SNP actions' own inputs
# ---------------------------------------------------------------------------

SNP_CELL_READS = 8_388_608       # the snp.call cell's reads, 8 shards


def captured_exchanges(action) -> list:
    """The inputs of each ``shuffle_partition`` call ``action()`` makes:
    (each source's leaves, counts, capacity, keys), in order; the calls
    run as they would."""
    from repro_torch.core import planner, tree
    real, seen = planner.shuffle_partition, []

    def keep(parts, keys, capacity=None, dests=None):
        if dests is not None:
            raise AssertionError("a salted exchange in a k-mer or SNP "
                                 "action")
        seen.append(([tree.leaves(p.records) for p in parts],
                     [p.count for p in parts],
                     capacity or parts[0].capacity, list(keys)))
        return real(parts, keys, capacity=capacity)

    planner.shuffle_partition = keep
    try:
        action()
    finally:
        planner.shuffle_partition = real
    return seen


def exchange_phase(name: str, inputs) -> dict:
    """The exchange kernel on one captured exchange: bit for bit against
    its plain version (one launch, the ``hash`` route), then both timed in
    turns (CUDA events around back-to-back calls), the kernel's device
    time by kernel, and the bound (``repro_torch.kernels.work.exchange``
    at the inputs' valid rows, read once outside the timing)."""
    import math
    import torch
    from repro_torch.core.shuffle import hash_keys
    from repro_torch.kernels import work
    from repro_torch.kernels.exchange import exchange, exchange_ref
    from repro_torch.kernels.exchange import kernel as xmod
    leaves, counts, cap, keys = inputs
    n = len(leaves)
    t0 = time.perf_counter()

    def kernel():
        return exchange(leaves, counts, cap, keys=keys)

    def plain():
        return exchange_ref(leaves, counts, cap,
                            [hash_keys(k) % n for k in keys])

    xmod.reset_launches()
    got, want = kernel(), plain()
    if xmod.LAUNCHES_BY_ROUTE != {"hash": 1, "dests": 0}:
        raise AssertionError(f"exchange {name}: launches "
                             f"{xmod.LAUNCHES_BY_ROUTE}")
    fields = ("counts", "send_counts", "dropped")
    compare(f"exchange {name}", [*got.leaves, *(getattr(got, f)
                                                 for f in fields)],
            [*want.leaves, *(getattr(want, f) for f in fields)])
    valid = int(torch.stack(counts).sum())
    received = got.counts.tolist()
    del got, want
    row_bytes = sum(x.element_size() * math.prod(x.shape[1:])
                    for x in leaves[0])
    bound = work.exchange(n, valid, keys[0].element_size(), row_bytes,
                          cap).bound()[0]
    (k_ms, p_ms), turns = in_turns(cuda_ms, [kernel, plain])
    by_kernel = device_ms_by_kernel(kernel)
    rec = {"shards": n, "rows": leaves[0][0].shape[0], "valid": valid,
           "capacity": cap, "leaves": len(leaves[0]),
           "row_bytes": row_bytes, "received": received, "ms": k_ms,
           "plain_ms": p_ms, "bound_ms": bound, "turns": turns,
           "by_kernel": by_kernel}
    phase(f"exchange {name}", t0, json.dumps(rec))
    return rec


def exchange_slice(fasta: str, seed: int) -> dict:
    """Slice 1b: the exchange of the k-mer action on the genome at
    ``fasta`` (``kmer12.collect``'s: 8 sources of 4**12 rows, 3 leaves,
    capacity ``keyed_bucket_capacity(4**12, 8)``) and of the SNP action
    over the cell's 8,388,608 reads (``snp.call``'s: 24 skewed keys,
    capacity 1,048,576), each on its action's own inputs; returns the
    kernel's JSON record."""
    import torch
    from repro_torch.core import MaRe
    from repro_torch.io import fasta_source
    src = fasta_source(fasta)

    def kmer():
        (MaRe.from_source(src, num_shards=NUM_SHARDS)
         .map(image="kmer-stats", command=f"kmer-stats {K}")
         .reduce_by_key(lambda r: r[0], value_by=lambda r: (r[1],),
                        op="sum")).dataset

    (kmer_inputs,) = captured_exchanges(kmer)
    rec = {"name": "exchange", "kmer12": exchange_phase("kmer12",
                                                        kmer_inputs)}
    del kmer_inputs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    library = make_library(SNP_CELL_READS, seed)
    ds = MaRe(library, num_shards=NUM_SHARDS, device="cuda").dataset
    del library
    phase("exchange SNP reads", t0, f"reads={SNP_CELL_READS}")
    (snp_inputs,) = captured_exchanges(lambda: snp_calling(ds).dataset)
    rec["snp"] = exchange_phase("snp", snp_inputs)
    del snp_inputs, ds
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# slice 5: the interactive and out-of-core runtime on the same genome
# ---------------------------------------------------------------------------

INTERACTIVE_QUERIES = 5
ASYNC_QUERIES = 3
COLD_REPS = 3
MIN_WAVES = 6


def kmer_key(r):
    return r[0]


def kmer_count(r):
    return (r[1],)


def kmer_query(base):
    """The k-mer table query over ``base`` (an ingested genome): the
    ``kmer-stats`` map, persisted or not, then the keyed sum."""
    return (base.map(image="kmer-stats", k=K)
            .reduce_by_key(kmer_key, value_by=kmer_count, op="sum"))


def kmer_table(out) -> np.ndarray:
    """The collected keyed sum as a dense table; each key on one shard
    (counted by ``bincount``: a sort of 15M keys takes seconds on the
    card's host)."""
    keys, (occ,), cnt = out
    if np.bincount(keys, minlength=4 ** K).max(initial=0) > 1:
        raise AssertionError("a k-mer key appears on two shards")
    if not np.array_equal(occ, cnt):
        raise AssertionError("occurrences != record counts")
    table = np.zeros(4 ** K, np.int64)
    table[keys] = occ
    return table


def check_table(what: str, out, want: np.ndarray) -> None:
    got = kmer_table(out)
    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: k-mer table differs from numpy at "
                             f"{int((got != want).sum())} keys")


def check_cached(what: str, report, tier: str) -> None:
    """The query started from the persisted map: one cached stage, from
    ``tier``, and only the keyed reduce executed."""
    if (report.cached_stages != 1 or report.executed_stages != 1
            or report.cache_tier != tier):
        raise AssertionError(f"{what}: {report.describe()}; expected the "
                             f"map served from the {tier} tier")


def timed_collect(m, **kw) -> tuple:
    import torch
    t0 = time.perf_counter()
    out = m.collect(**kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def segment_launches() -> int:
    from repro_torch.kernels.segment_reduce import kernel as kmod
    return kmod.LAUNCHES


def interactive_path(genome: dict) -> dict:
    """The paper's interactive session (persisted prefix) on the chr21
    genome: cold queries, then ``map(kmer-stats).persist()`` and
    INTERACTIVE_QUERIES keyed-sum queries from the device tier, one from
    the host tier after a forced spill, and ASYNC_QUERIES asynchronous
    ones; every table equal to numpy's bincount.  Returns the numbers it
    printed."""
    import torch
    from repro_torch.core import MaRe
    from repro_torch.io import fasta_source
    from repro_torch.runtime import (Executor, MaterializationCache,
                                     estimate_nbytes)

    want = genome["table"]
    src = fasta_source(genome["fasta"])
    t0 = time.perf_counter()
    ds = MaRe.from_source(src, num_shards=NUM_SHARDS).dataset
    torch.cuda.synchronize()
    phase("interactive: ingest", t0, f"records={int(ds.counts.sum())}")

    # cold: no persisted prefix, the map runs in every query
    cold_walls = []
    for i in range(COLD_REPS):
        before = segment_launches()
        out, wall = timed_collect(kmer_query(MaRe(ds, executor=Executor())))
        check_table(f"cold query {i}", out, want)
        if segment_launches() - before != 2 * NUM_SHARDS:
            raise AssertionError("cold query: segment-sum launches "
                                 f"{segment_launches() - before}")
        cold_walls.append(wall)

    t0 = time.perf_counter()
    reset_launches()
    ex = Executor()
    base = MaRe(ds, executor=ex)
    persisted = base.map(image="kmer-stats", k=K).persist()
    entry = ex.mat_cache.entry(persisted.dataset.lineage)
    if entry is None or entry.tier != "device":
        raise AssertionError(f"persisted map not on the device tier: "
                             f"{ex.mat_cache.stats()}")
    nbytes = estimate_nbytes(persisted.dataset)
    cached_walls, per_query = [], []
    for i in range(INTERACTIVE_QUERIES):
        before = segment_launches()
        q = kmer_query(base)
        out, wall = timed_collect(q)
        per_query.append(segment_launches() - before)
        check_table(f"cached query {i}", out, want)
        check_cached(f"cached query {i}", q.report(), "device")
        cached_walls.append(wall)
    read_launches("interactive",
                  {"segment_sum": 2 * NUM_SHARDS * INTERACTIVE_QUERIES})
    if per_query != [2 * NUM_SHARDS] * INTERACTIVE_QUERIES:
        raise AssertionError(f"segment-sum launches a query: {per_query}")
    phase("interactive: persisted queries", t0,
          f"queries={INTERACTIVE_QUERIES} segment_sum_per_query="
          f"{per_query} cold_wall_ms={[w * 1e3 for w in cold_walls]} "
          f"cached_wall_ms={[w * 1e3 for w in cached_walls]} "
          f"cold_median_ms={np.median(cold_walls) * 1e3:.3f} "
          f"cached_median_ms={np.median(cached_walls) * 1e3:.3f} "
          f"entry_nbytes={nbytes}")

    # the host tier: a cache whose device budget is below the estimate
    t0 = time.perf_counter()
    reset_launches()
    spill_ex = Executor(mat_cache=MaterializationCache(
        device_budget_bytes=nbytes - 1))
    spill_base = MaRe(ds, executor=spill_ex)
    spilled = spill_base.map(image="kmer-stats", k=K).persist()
    entry = spill_ex.mat_cache.entry(spilled.dataset.lineage)
    if (entry.tier != "host" or entry.dataset is not None
            or any(t.is_cuda for t in [entry.host_counts,
                                       *entry.host_records])):
        raise AssertionError(f"spill left device tensors: "
                             f"{spill_ex.mat_cache.stats()}")
    del spilled
    q = kmer_query(spill_base)
    out, wall = timed_collect(q)
    restored = q.report()
    check_table("host-tier query", out, want)
    check_cached("host-tier query", restored, "host")
    if q.dataset.device != ds.device:
        raise AssertionError(f"restored to {q.dataset.device}, the dataset "
                             f"lives on {ds.device}")
    read_launches("interactive_host", {"segment_sum": 2 * NUM_SHARDS})
    phase("interactive: host-tier restore", t0,
          f"query_wall_ms={wall * 1e3:.3f} "
          f"cache_lookup_ms={restored.phases['cache_lookup'] * 1e3:.3f} "
          f"device={q.dataset.device} stats="
          f"{json.dumps(spill_ex.mat_cache.stats())}")
    del q, spill_base, spill_ex

    # asynchronous: the same query, FIFO, equal to the synchronous tables
    t0 = time.perf_counter()
    reset_launches()
    handles = [kmer_query(base).collect(asynchronous=True, label=f"q{i}")
               for i in range(ASYNC_QUERIES)]
    for i, h in enumerate(handles):
        check_table(f"async query {i}", h.result(timeout=600), want)
        check_cached(f"async query {i}", h.report, "device")
    ids = [h.report.action_id for h in handles]
    labels = [r.label for r in ex.reports if r.label]
    if ids != sorted(ids) or labels != [f"q{i}" for i in
                                        range(ASYNC_QUERIES)]:
        raise AssertionError(f"async queries out of order: ids {ids}, "
                             f"labels {labels}")
    read_launches("interactive_async",
                  {"segment_sum": 2 * NUM_SHARDS * ASYNC_QUERIES})
    waits = [h.queue_wait_s for h in handles]
    phase("interactive: async queries", t0,
          f"queue_wait_ms={[w * 1e3 for w in waits]} "
          f"action_wall_ms={[h.report.wall_s * 1e3 for h in handles]}")
    ex.mat_cache.clear()
    return {"cold_ms": np.median(cold_walls) * 1e3,
            "cached_ms": np.median(cached_walls) * 1e3,
            "restore_ms": wall * 1e3, "entry_nbytes": nbytes,
            "queue_wait_ms": [w * 1e3 for w in waits]}


def wave_capacity(waves, num_shards: int) -> int:
    """A per-shard record capacity that holds every wave's largest shard:
    FASTA lines of LINE bases and a newline, plus one partial line a
    split and the header."""
    from repro_torch.io.splits import assign_splits
    most = max(sum(sp.length for sp in b) // (LINE + 1) + len(b) + 1
               for w in waves for b in assign_splits(w, num_shards))
    return -(-most // 64) * 64


def gc_pipeline(m):
    return (m.map(image="ubuntu", command="grep-chars GC")
            .reduce(image="ubuntu", command="awk-sum"))


def waves_path(genome: dict) -> dict:
    """Out of core: the GC count over the genome in at least MIN_WAVES
    waves (8 splits of 1 MiB each, a card-sized budget cut down to force
    waves), against numpy and the one-shot action, with the peak of
    allocated device memory of each."""
    import torch
    from repro_torch.core import MaRe, PlanCache
    from repro_torch.io import WaveRunner, fasta_source

    seq = genome["seq"]
    want = int(np.count_nonzero((seq == ord("G")) | (seq == ord("C"))))
    src = fasta_source(genome["fasta"])
    splits = src.splits()
    wave_bytes = NUM_SHARDS * max(sp.length for sp in splits)
    waves_planned = WaveRunner(src, num_shards=NUM_SHARDS,
                               wave_bytes=wave_bytes).waves()
    if len(waves_planned) < MIN_WAVES:
        raise AssertionError(f"{len(waves_planned)} waves < {MIN_WAVES}")
    cap = wave_capacity(waves_planned, NUM_SHARDS)
    dev = torch.device("cuda")

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    (one,) = gc_pipeline(MaRe.from_source(src, num_shards=NUM_SHARDS)
                         ).collect(shard=0)
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated(dev) - base_bytes

    def run_waves(prefetch: bool, plan_cache=None) -> tuple:
        """One wave run: (runner, total, wall s, its wave / wave.ingest
        span sums in ms)."""
        from repro_torch.obs import TRACER
        seen = len(TRACER.events())
        runner = gc_pipeline(WaveRunner(src, num_shards=NUM_SHARDS,
                                        wave_bytes=wave_bytes, capacity=cap,
                                        width=64, prefetch=prefetch,
                                        plan_cache=plan_cache))
        t0 = time.perf_counter()
        (total,) = runner.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if int(total[0]) != want:
            raise AssertionError(f"GC count in waves (prefetch={prefetch}) "
                                 f"{int(total[0])} != numpy {want}")
        events = TRACER.events()[seen:]
        spans = {n: sum(e["dur"] for e in events if e["name"] == n) / 1e3
                 for n in ("wave", "wave.ingest")}
        return runner, wall, spans

    torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev)
    runner, wave_wall, wave_spans = run_waves(True, PlanCache())
    wave_peak = torch.cuda.max_memory_allocated(dev) - base_bytes
    stats = runner.stats
    # in turns with the same waves without the ingest lookahead (each wave
    # ingested only after the previous action resolved): with, without,
    # without, with
    t0 = time.perf_counter()
    walls = {"lookahead": [wave_wall], "no_lookahead": []}
    spans = {"lookahead": [wave_spans], "no_lookahead": []}
    for prefetch in (False, False, True):
        key = "lookahead" if prefetch else "no_lookahead"
        _, wall, sp = run_waves(prefetch)
        walls[key].append(wall * 1e3)
        spans[key].append(sp)
    walls["lookahead"][0] *= 1e3
    read_launches("waves", {})
    if int(one[0]) != want:
        raise AssertionError(f"GC count one-shot {int(one[0])} != numpy "
                             f"{want}")
    if stats["num_waves"] < MIN_WAVES or stats["programs_compiled"] > 2:
        raise AssertionError(f"wave stats {stats}")
    if not wave_peak < one_peak:
        raise AssertionError(f"wave peak {wave_peak} B >= one-shot peak "
                             f"{one_peak} B")
    phase("waves: GC count out of core", t0,
          f"gc={want} numpy={want} stats={json.dumps(stats)} "
          f"capacity={cap} wave_bytes={wave_bytes} "
          f"wall_ms={json.dumps(walls)} span_ms={json.dumps(spans)} "
          f"one_shot_wall_ms={one_wall * 1e3:.3f} "
          f"wave_peak_bytes={wave_peak} one_shot_peak_bytes={one_peak}")
    return {"num_waves": stats["num_waves"], "wall_ms": walls,
            "span_ms": spans, "one_shot_ms": one_wall * 1e3,
            "wave_peak": wave_peak, "one_shot_peak": one_peak}


def runtime_slice(genome: dict, tmp: str) -> None:
    """The interactive and the out-of-core paths under an enabled tracer;
    the exported Chrome trace and the metrics are checked after both."""
    from repro_torch.core import MaRe
    from repro_torch.obs import METRICS, tracing

    METRICS.reset()
    with tracing() as tracer:
        inter = interactive_path(genome)
        wave = waves_path(genome)
    # any handle: trace_to and metrics read the process-wide tracer and
    # registry
    handle = MaRe((np.zeros(1, np.int32),))
    path = handle.trace_to(os.path.join(tmp, "runtime_trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    missing = {"ingest", "wave", "wave.ingest", "cache.spill",
               "cache.host_restore"} - names
    if missing:
        raise AssertionError(f"trace lacks {sorted(missing)}")
    spans = {n: sum(e["dur"] for e in events if e["name"] == n) / 1e3
             for n in ("cache.spill", "cache.host_restore")}
    snap = handle.metrics()
    # four wave runs: two with and two without the ingest lookahead
    if (snap.get("mat_cache.device.hits", 0) < INTERACTIVE_QUERIES
            or snap.get("waves.completed") != 4 * wave["num_waves"]):
        raise AssertionError(
            f"metrics: mat_cache.device.hits="
            f"{snap.get('mat_cache.device.hits')}, waves.completed="
            f"{snap.get('waves.completed')} of 4 x {wave['num_waves']} "
            f"waves")
    print("[runtime] " + json.dumps({
        "interactive": inter, "waves": wave, "span_ms": spans,
        "trace_events": len(events), "events_dropped":
        tracer.events_dropped, "metrics": {
            k: snap[k] for k in ("mat_cache.device.hits",
                                 "mat_cache.host.hits",
                                 "mat_cache.device.evictions",
                                 "waves.completed",
                                 "executor.actions")}}), flush=True)


# ---------------------------------------------------------------------------
# slice 6: the tuner, streaming and the query service on the same genome
# ---------------------------------------------------------------------------

STREAM_FILES = 8
WINDOW = 3
TUNE_REPS = 2
SERVICE_ARGS = ["--service", "--tenants", "4", "--rounds", "6", "--reads",
                "778500", "--k", str(K), "--batch-window", "0.05",
                "--num-shards", str(NUM_SHARDS)]


def epoch_files(genome: dict, tmp: str, n: int = STREAM_FILES) -> list:
    """The genome as ``n`` FASTA files of equal whole lines, written to a
    staging directory (an inbox receives them by ``os.replace``): a list
    of ``(staged path, name, numpy k-mer table of the file)``."""
    seq = genome["seq"]
    lines = -(-len(seq) // LINE)
    per = -(-lines // n)
    staging = os.path.join(tmp, "staging")
    os.makedirs(staging, exist_ok=True)
    out = []
    for i in range(n):
        chunk = seq[i * per * LINE:(i + 1) * per * LINE]
        path = os.path.join(staging, f"part{i}.fa")
        write_fasta(path, chunk)
        out.append((path, f"part{i}.fa", kmer_bincount(chunk, K)))
    if not np.array_equal(sum(t for _, _, t in out), genome["table"]):
        raise AssertionError("the files' k-mer tables do not add up to the "
                             "genome's")
    return out


def stream_capacity(files: list) -> int:
    """Per-shard record capacity of the largest epoch (one file)."""
    from repro_torch.io import fasta_source
    return wave_capacity([fasta_source(p).splits() for p, _, _ in files],
                         NUM_SHARDS)


def stream_executor():
    """An executor with the default materialization cache (its device
    tier a share of the card's memory)."""
    from repro_torch.runtime import Executor
    return Executor()


def new_inbox(tmp: str, name: str) -> str:
    path = os.path.join(tmp, name)
    os.makedirs(path)
    return path


def drop(inbox: str, staged: str, name: str) -> None:
    """A file arrives whole: a copy of the staged file, moved in."""
    tmp = staged + ".copy"
    shutil.copyfile(staged, tmp)
    os.replace(tmp, os.path.join(inbox, name))


def table_of(ds) -> np.ndarray:
    """A maintained k-mer state as a dense numpy table."""
    from repro_torch.core.dataset import collect
    return kmer_table(collect(ds))


def tune_path(genome: dict) -> dict:
    """The segment-reduce dispatch at the k-mer action's combine and merge
    shapes: on the card a sum takes the kernel without measuring (no
    tune-report row names the card), and the same action's wall with the
    static choice (``REPRO_SEGMENT_AUTOTUNE=0``) beside the default, every
    launch on the binned route."""
    import torch
    from repro_torch.core import MaRe
    from repro_torch.io import fasta_source
    from repro_torch.kernels.segment_reduce import ops, tune
    from repro_torch.runtime import Executor

    want = genome["table"]
    nk = 4 ** K
    dev = torch.device("cuda")
    chosen = {name: ops.resolve_strategy(
        None, "sum", n, nk, (torch.zeros((1, d), dtype=torch.int32,
                                         device=dev),), device=dev)
        for (name, n), d in zip(genome["shapes"].items(), (1, 2))}
    measured = [e for e in tune.tune_report() if e["device"] != "cpu"]
    if set(chosen.values()) != {"kernel"} or measured:
        raise AssertionError(f"segment-reduce dispatch on the card: "
                             f"{chosen}, measured {measured}")
    ds = MaRe.from_source(fasta_source(genome["fasta"]),
                          num_shards=NUM_SHARDS).dataset
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_launches()
    walls: dict = {"static": [], "default": []}
    saved = os.environ.get("REPRO_SEGMENT_AUTOTUNE")
    for mode in ("static", "default"):
        if mode == "static":
            os.environ["REPRO_SEGMENT_AUTOTUNE"] = "0"
        try:
            for i in range(TUNE_REPS):
                out, wall = timed_collect(kmer_query(MaRe(
                    ds, executor=Executor())))
                check_table(f"{mode} query {i}", out, want)
                walls[mode].append(wall * 1e3)
        finally:
            if saved is None:
                os.environ.pop("REPRO_SEGMENT_AUTOTUNE", None)
            else:
                os.environ["REPRO_SEGMENT_AUTOTUNE"] = saved
    read_launches("tune", {"segment_sum": 2 * NUM_SHARDS * 2 * TUNE_REPS})
    phase("tune: static vs default", t0,
          f"wall_ms={json.dumps(walls)} chosen={json.dumps(chosen)} "
          f"measured_on_card={len(measured)}")
    return {"chosen": chosen, "wall_ms": walls}


def stream_path(files: list, tmp: str, cap: int) -> dict:
    """The incremental k-mer stream: one file an epoch dropped into an
    inbox, one ``update()`` each; the state equals numpy's table over the
    files so far after every epoch and the one-shot action over all of
    them at the end, bit for bit, with one fold signature."""
    import torch
    from repro_torch.core import MaRe, PlanCache
    from repro_torch.core.dataset import collect
    from repro_torch.io import fasta_source
    from repro_torch.stream import ContinuousSource, IncrementalQuery

    inbox = new_inbox(tmp, "stream")
    ex = stream_executor()
    cont = ContinuousSource(fasta_source(inbox), num_shards=NUM_SHARDS,
                            device="cuda", capacity=cap)
    q = IncrementalQuery(cont, kmer_query, executor=ex,
                         plan_cache=PlanCache())
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    want = np.zeros(4 ** K, np.int64)
    epochs = []
    reset_launches()
    for i, (staged, name, table) in enumerate(files):
        drop(inbox, staged, name)
        torch.cuda.synchronize()
        u0 = time.perf_counter()
        upd = q.update()
        torch.cuda.synchronize()
        update_s = time.perf_counter() - u0
        if upd is None or upd.epoch != i or upd.new_splits < 1:
            raise AssertionError(f"stream epoch {i}: {upd}")
        want += table
        if not np.array_equal(table_of(q.state), want):
            raise AssertionError(f"stream epoch {i}: state != numpy")
        epochs.append({"update_s": update_s, "fold_s": upd.fold_s,
                       "allocated": torch.cuda.memory_allocated(dev),
                       "splits": upd.new_splits})
    # a delta action is a combine and a merge a shard; every epoch after
    # the first folds the state with the delta, one merge a shard
    launches = len(files) * 2 * NUM_SHARDS + (len(files) - 1) * NUM_SHARDS
    read_launches("stream", {"segment_sum": launches})
    if q.fold_engine.compiles != 1 or q.fold_engine.folds != \
            len(files) - 1:
        raise AssertionError(f"fold compiles {q.fold_engine.compiles}, "
                             f"folds {q.fold_engine.folds}")
    got = collect(q.state)
    one = kmer_query(MaRe.from_source(fasta_source(inbox),
                                      num_shards=NUM_SHARDS)).collect()
    leaves = lambda o: (o[0], o[1][0], o[2])
    for a, b in zip(leaves(got), leaves(one)):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError("stream state != one-shot action")
    phase("stream: incremental k-mer table", t0,
          f"epochs={len(files)} capacity={cap} launches={launches} "
          f"fold_compiles={q.fold_engine.compiles} "
          f"per_epoch={json.dumps(epochs)} one_shot=bit-identical "
          f"device_budget={ex.mat_cache.device_budget_bytes} "
          f"cache={json.dumps(ex.mat_cache.stats())}")
    ex.mat_cache.clear()
    return {"epochs": epochs, "launches": launches}


def window_path(files: list, tmp: str, cap: int) -> dict:
    """A sliding window of WINDOW epochs, slide 1, over the same files:
    every emitted window equals numpy's table over its epochs; the
    evicted partials leave the cache."""
    import torch
    from repro_torch.core import PlanCache
    from repro_torch.io import fasta_source
    from repro_torch.stream import ContinuousSource, WindowedQuery

    inbox = new_inbox(tmp, "window")
    ex = stream_executor()
    w = WindowedQuery(ContinuousSource(fasta_source(inbox),
                                       num_shards=NUM_SHARDS, device="cuda",
                                       capacity=cap),
                      kmer_query, size=WINDOW, slide=1, executor=ex,
                      plan_cache=PlanCache())
    t0 = time.perf_counter()
    fold_s = []
    reset_launches()
    for i, (staged, name, _) in enumerate(files):
        drop(inbox, staged, name)
        upd = w.update()
        torch.cuda.synchronize()
        ring = w.window_epochs
        if ring != tuple(range(max(0, i - WINDOW + 1), i + 1)):
            raise AssertionError(f"window after epoch {i}: {ring}")
        want = sum(files[e][2] for e in ring)
        if not np.array_equal(table_of(w.state), want):
            raise AssertionError(f"window {ring} != numpy")
        fold_s.append(upd.fold_s)
    folds = sum(min(i, WINDOW - 1) for i in range(len(files)))
    launches = (len(files) * 2 + folds) * NUM_SHARDS
    read_launches("window", {"segment_sum": launches})
    evicted = len(files) - WINDOW
    stats = ex.mat_cache.stats()
    # the cache holds the ring's partials and the newest window; every
    # evicted partial and superseded window was dropped
    if (w.evicted != evicted or len(ex.mat_cache) != WINDOW + 1
            or stats["invalidations"] != evicted + len(files) - 1
            or w.fold_engine.folds != folds):
        raise AssertionError(f"window: evicted {w.evicted}, entries "
                             f"{len(ex.mat_cache)}, stats {stats}, folds "
                             f"{w.fold_engine.folds}")
    phase("window: sliding k-mer tables", t0,
          f"size={WINDOW} slide=1 evicted={w.evicted} folds={folds} "
          f"launches={launches} fold_s={fold_s} cache={json.dumps(stats)}")
    ex.mat_cache.clear()
    return {"evicted": w.evicted, "fold_s": fold_s, "launches": launches}


def live_path(files: list, tmp: str, cap: int) -> dict:
    """A live query through a tenant's session: files dropped while
    ``follow()`` waits; every refresh's report reaches the session with
    its tenant and epoch, the state equals numpy's table, and ``stop()``
    re-raises nothing."""
    import queue
    import torch
    from repro_torch.io import fasta_source
    from repro_torch.serve import QueryService, ServiceConfig
    from repro_torch.stream import ContinuousSource, LiveQuery

    inbox = new_inbox(tmp, "live")
    refreshed: "queue.Queue" = queue.Queue()
    t0 = time.perf_counter()
    follow_ms = []
    want = np.zeros(4 ** K, np.int64)
    reset_launches()
    with QueryService(executor=stream_executor(), config=ServiceConfig(
            batch_window_s=0.0)) as svc:
        sess = svc.session("alice")
        q = sess.stream(ContinuousSource(fasta_source(inbox),
                                         num_shards=NUM_SHARDS,
                                         device="cuda", capacity=cap),
                        kmer_query)
        seen = 0
        live = LiveQuery(q, interval_s=0.05, on_refresh=refreshed.put)
        with live:
            for i, (staged, name, table) in enumerate(files):
                f0 = time.perf_counter()
                drop(inbox, staged, name)
                reports = sess.follow(seen, timeout=300)
                upd = refreshed.get(timeout=300)
                follow_ms.append((time.perf_counter() - f0) * 1e3)
                seen += len(reports)
                rep = reports[-1]
                if (len(reports) != 1 or rep.tenant != "alice"
                        or upd.epoch != i
                        or rep.counters.get("stream.epoch") != i):
                    raise AssertionError(
                        f"live epoch {i}: {len(reports)} reports, "
                        f"tenant {rep.tenant}, update epoch "
                        f"{upd.epoch}, counters {rep.counters}")
                want += table
        if live.error is not None or live.running:
            raise AssertionError(f"live query: {live}")
        torch.cuda.synchronize()
        if not np.array_equal(table_of(q.state), want):
            raise AssertionError("live state != numpy")
        cache_stats = svc.executor.mat_cache.stats()
        svc.executor.mat_cache.clear()
    launches = len(files) * 2 * NUM_SHARDS + (len(files) - 1) * NUM_SHARDS
    read_launches("live", {"segment_sum": launches})
    phase("live: session follow loop", t0,
          f"refreshes={live.refreshes} follow_ms={follow_ms} "
          f"reports={seen} cache={json.dumps(cache_stats)}")
    return {"follow_ms": follow_ms, "refreshes": live.refreshes}


def reads_kmer_table(reads: np.ndarray, k: int) -> np.ndarray:
    """numpy's k-mer table over fixed-length ACGT reads."""
    code = np.zeros(256, np.int64)
    for i, b in enumerate(b"ACGT"):
        code[b] = i
    nw = reads.shape[1] - k + 1
    acc = np.zeros((reads.shape[0], nw), np.int64)
    for j in range(k):
        acc = acc * 4 + code[reads[:, j:j + nw]]
    return np.bincount(acc.reshape(-1), minlength=4 ** k)


def service_path() -> dict:
    """``launch.serve --service`` in process: 4 tenants, 6 rounds (sum,
    max, min twice), ~50 Mbases of reads, k = 12; tables against numpy
    and the same plans outside the service, coalesced dispatches, 16
    segment-sum launches a sum group and 8 a max or min group."""
    from repro_torch.core import MaRe
    from repro_torch.launch import serve
    from repro_torch.runtime import Executor

    args = serve.parse_args(SERVICE_ARGS)
    t0 = time.perf_counter()
    reset_launches()
    run = serve.service_loop(args)
    groups = {op: {r.batch_leader for reps in run.reports.values()
                   for r in reps if r.label == f"{op} query"}
              for op in serve.QUERY_OPS}
    sum_groups = groups["sum"]
    # a sum group folds its values and counts in one launch a shard at
    # the combine and at the merge; a max or min group folds its values
    # by scatter and only its merge's counts through the kernel
    other_groups = len(groups["max"]) + len(groups["min"])
    read_launches("service", {"segment_sum": 2 * NUM_SHARDS
                              * len(sum_groups)
                              + NUM_SHARDS * other_groups})
    for line in serve.service_lines(args, run):
        print(f"[service] {line}", flush=True)
    t1 = time.perf_counter()
    reads = serve.make_reads(args.reads, args.seed)["data"]
    want = reads_kmer_table(reads, args.k)
    alone = {op: MaRe(run.shared, executor=Executor()).map(
        image="kmer-stats", k=args.k).reduce_by_key(
        serve._key_of, value_by=serve._ones_of, op=op,
        num_keys=4 ** args.k).collect() for op in ("max", "min")}
    first_sum = None
    for tenant, results in run.results.items():
        if [op for op, _ in results] != [serve.QUERY_OPS[i % 3]
                                         for i in range(args.rounds)]:
            raise AssertionError(f"{tenant}: {[op for op, _ in results]}")
        for op, out in results:
            leaves = (out[0], out[1][0], out[2])
            if op == "sum":
                if first_sum is None:
                    check_table(f"{tenant} sum", out, want)
                    first_sum = leaves
                elif not all(np.array_equal(a, b) for a, b in
                             zip(leaves, first_sum)):
                    raise AssertionError(f"{tenant} sum != the first sum")
            elif not all(np.array_equal(a, b) for a, b in
                         zip(leaves, (alone[op][0], alone[op][1][0],
                                      alone[op][2]))):
                raise AssertionError(f"{tenant} {op} != outside the "
                                     f"service")
    st = run.cache_stats
    if (run.occupancy <= 1 or st["tenant_budget_violations"]
            or st["shared_hits"] < 1):
        raise AssertionError(f"service: occupancy {run.occupancy}, "
                             f"cache {st}")
    phase("service: tenants x rounds", t0,
          f"dispatches={run.dispatches} sum_groups={len(sum_groups)} "
          f"max_min_groups={other_groups} "
          f"occupancy={run.occupancy:.4f} qps={run.qps:.4f} "
          f"p50_ms={run.latency(0.5) * 1e3:.3f} "
          f"p99_ms={run.latency(0.99) * 1e3:.3f} "
          f"wall_s={run.wall_s:.4f} shared_hits={st['shared_hits']} "
          f"violations={st['tenant_budget_violations']} "
          f"check_s={time.perf_counter() - t1:.3f}")
    return {"dispatches": run.dispatches, "sum_groups": len(sum_groups),
            "occupancy": run.occupancy, "qps": run.qps,
            "p50_ms": run.latency(0.5) * 1e3,
            "p99_ms": run.latency(0.99) * 1e3, "wall_s": run.wall_s,
            "shared_hits": st["shared_hits"]}


def stream_service_slice(genome: dict, tmp: str) -> None:
    """Slice 6 under an enabled tracer: the segment-reduce dispatch, the
    incremental stream, the sliding window, the live query and the
    service."""
    from repro_torch.obs import tracing

    with tracing() as tracer:
        tuned = tune_path(genome)
        t0 = time.perf_counter()
        files = epoch_files(genome, tmp)
        cap = stream_capacity(files)
        phase("stream: epoch files", t0, f"files={len(files)} "
              f"capacity={cap}")
        stream = stream_path(files, tmp, cap)
        window = window_path(files, tmp, cap)
        live = live_path(files, tmp, cap)
        service = service_path()
    events = tracer.events()
    spans = {n: sum(e["dur"] for e in events if e["name"] == n) / 1e3
             for n in ("stream.update", "stream.fold", "stream.ingest",
                       "stream.window.update", "action")}
    print("[slice6] " + json.dumps({
        "tune": tuned, "stream": stream, "window": window, "live": live,
        "service": service, "span_ms": spans}), flush=True)


# ---------------------------------------------------------------------------
# slice 2: Llama-3.2-1B serving at full width
# ---------------------------------------------------------------------------

FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:86"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
RMS_REPLACES = "src/repro/kernels/rmsnorm/kernel.py:27"
RMS_SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
# kernel vs plain version taken in f32: bf16 output rounds once to 8
# mantissa bits (2e-2 for |out| < 4, as the reference's kernel tests);
# f32 differs in summation order only
FLASH_TOL = {"torch.bfloat16": 2e-2, "torch.float32": 2e-5}
RMS_TOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-6}
# Logits of two bf16 paths through 16 layers differ by bf16 roundings at
# other places (each path rounds its attention output, the decode path
# its one-row products): at 16 layers of this width on the CPU (seq 256,
# vocab 8192) the largest difference was 1.9-2.4% of the largest |logit|,
# for plain vs kernel-order attention and for decode vs forward.  Allow
# 10%.  A wrong mask or head mapping moves logits by their spread, which
# is 15-20% of the largest.
LOGIT_TOL_FRAC = 0.1
TEACHER_FORCED = 4
# At a served shape the bf16 output is also held to the plain version in
# f32 by relative RMS error, ||got - want|| / ||want||: the kernel rounds
# P and its output to bf16, at most 2**-9 of each element.  A fault that
# moves every output of a row alike reads several times higher: the
# zero-filled keys of a not-causal call's partial last key tile, left in
# the softmax, shrink every output by their share of its denominator (36
# keys of 1,536 at 1,500 frames).  Each run plants that fault in the
# plain version and shows that this limit rejects it.
FLASH_REL_RMS_TOL = 6e-3
FLASH_KEY_TILE = 128             # the wgmma route's keys a tile

VLM_ARCH = "internvl2-1b"
VLM_PARAMS = 494_556_160         # the reference's init_lm leaves, counted
VLM_PATCHES = 256
AUDIO_ARCH = "whisper-base"
AUDIO_PARAMS = 70_658_560        # the reference's init_encdec leaves
AUDIO_FRAMES = 1500
# whisper's decoder context (max_target_positions, 448 positions), filled
# by the prompt and the greedy tokens
AUDIO_CONTEXT = 448
AUDIO_PROMPT = AUDIO_CONTEXT - GEN


def flash_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps, per head
    (``repro_torch.kernels.work.flash_pairs``)."""
    from repro_torch.kernels import work
    return work.flash_pairs(sq, sk, causal, window)


def flash_bound(b, hq, hkv, sq, sk, d, causal, window, itemsize):
    """(bound ms, by) of attention on these inputs
    (``repro_torch.kernels.work.flash``: q.k and p.v over the kept pairs
    at the tensor cores' peak for the inputs' type, against q, k, v read
    once and o written once over HBM bandwidth)."""
    from repro_torch.kernels import work
    return work.flash(b * hq, hq // hkv, sq, sk, d, causal, window,
                      itemsize).bound()


def rms_bound(rows: int, d: int, itemsize: int):
    """(bound ms, by) of RMSNorm (``repro_torch.kernels.work.rmsnorm``:
    x, w read once, out written once; its operations take far less)."""
    from repro_torch.kernels import work
    return work.rmsnorm(rows, d, itemsize).bound()


def flash_shape(b, hq, hkv, sq, sk, causal, window) -> tuple:
    """The flash wrapper's key in its ``LAUNCHES_BY_SHAPE`` for a bf16
    call at head dim 64 (the wgmma route): q [b * hq, sq, 64] against k,
    v [b * hkv, sk, 64], GQA group hq // hkv, causal, window."""
    return ("wgmma", b * hq, hq // hkv, sq, sk, 64, causal, window)


def rel_rms(got, want) -> float:
    """||got - want|| / ||want|| in f32."""
    return float((got.float() - want).norm() / want.norm())


def flash_check(dev, g, name, b, hq, hkv, sq, sk, d, dt, causal, window,
                rel_tol: Optional[float] = None):
    """One flash launch on random inputs against the plain version taken
    in f32; returns ({"max_abs_err": ...}, (q, k, v)).  With ``rel_tol``
    also holds the relative RMS error to it, and where a not-causal
    call's last key tile is partial, plants the fault of that tile's
    zero-filled keys left in the softmax into the plain version and
    shows that the same limit rejects it; both readings are returned."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    t0 = time.perf_counter()
    q = torch.randn((b, hq, sq, d), device=dev, generator=g).to(dt)
    k = torch.randn((b, hkv, sk, d), device=dev, generator=g).to(dt)
    v = torch.randn((b, hkv, sk, d), device=dev, generator=g).to(dt)
    before = fmod.LAUNCHES
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if fmod.LAUNCHES - before != 1:
        raise AssertionError(f"flash {name}: "
                             f"{fmod.LAUNCHES - before} launches")
    q3, k3, v3 = (t.float().reshape(-1, t.shape[2], d) for t in (q, k, v))
    want = flash_attention_plain(q3, k3, v3, hq // hkv, causal=causal,
                                 window=window).reshape(b, hq, sq, d)
    err = float((got.float() - want).abs().max())
    tol = FLASH_TOL[str(dt)]
    if got.dtype != dt or not err < tol:
        raise AssertionError(f"flash {name}: {got.dtype}, max abs err "
                             f"{err} vs tolerance {tol}")
    empty = sq - sk if causal and sq > sk else 0
    if empty and not bool((got[:, :, :empty] == 0).all()):
        raise AssertionError(f"flash {name}: a row without keys is not 0")
    check, extra = {"max_abs_err": err}, ""
    if rel_tol is not None:
        check["rel_rms_err"] = rel_rms(got, want)
        if not check["rel_rms_err"] <= rel_tol:
            raise AssertionError(f"flash {name}: relative RMS error "
                                 f"{check['rel_rms_err']} > {rel_tol}")
        tail = sk % FLASH_KEY_TILE
        if not causal and window is None and tail:
            pad = torch.zeros((k3.shape[0], FLASH_KEY_TILE - tail, d),
                              device=dev)
            bad = flash_attention_plain(
                q3, torch.cat([k3, pad], 1), torch.cat([v3, pad], 1),
                hq // hkv, causal=False).reshape(b, hq, sq, d).to(dt)
            check["planted_tail_fault_rel_rms_err"] = rel_rms(bad, want)
            del bad, pad
            if not check["planted_tail_fault_rel_rms_err"] > rel_tol:
                raise AssertionError(
                    f"flash {name}: the check passes the planted fault "
                    f"(relative RMS error "
                    f"{check['planted_tail_fault_rel_rms_err']})")
        extra = f" rel_rms_err={check['rel_rms_err']} rel_tol={rel_tol}" + (
            f" planted_tail_fault_rel_rms_err="
            f"{check['planted_tail_fault_rel_rms_err']} (last key tile "
            f"{tail} keys)" if "planted_tail_fault_rel_rms_err" in check
            else "")
    del want, q3, k3, v3
    phase(f"flash check {name}", t0,
          f"q={tuple(q.shape)} kv={tuple(k.shape)} {dt} causal={causal}"
          f" window={window} max_abs_err={err} tol={tol}"
          f" rows_without_keys={empty * b * hq}" + extra)
    return check, (q, k, v)


#: The served attention shapes, each checked on the wgmma route and timed
#: (batch BATCH, head dim 64, bf16): name, q heads, kv heads, Sq, Sk,
#: causal, window.  Every one must be launched by a path of this run.
FLASH_SERVED = (
    ("llama3.2-1b", 32, 8, PROMPT, PROMPT, True, None),
    ("granite-moe-1b-a400m", 16, 8, PROMPT, PROMPT, True, None),
    ("hymba-1.5b window 1024", 25, 5, PROMPT, PROMPT, True, 1024),
    ("hymba-1.5b global", 25, 5, PROMPT, PROMPT, True, None),
    # internvl2's prefill over its patches and the prompt, GQA group 7
    ("internvl2-1b prefill", 14, 2, VLM_PATCHES + PROMPT,
     VLM_PATCHES + PROMPT, True, None),
    # whisper's encoder over its frames: the last key tile holds 92 keys
    ("whisper-base encoder", 8, 8, AUDIO_FRAMES, AUDIO_FRAMES, False,
     None),
    # the teacher-forced forward over the decoder's 448 positions: cross
    # attention to the frames, and self attention
    ("whisper-base cross attention (forward)", 8, 8, AUDIO_CONTEXT,
     AUDIO_FRAMES, False, None),
    ("whisper-base decoder self attention (forward)", 8, 8, AUDIO_CONTEXT,
     AUDIO_CONTEXT, True, None))


def flash_simt_bf16(q3, k3, v3, group: int):
    """The CUDA-core kernel on bf16 through its C entry: the route bf16
    took before the tensor-core kernel, timed beside it.  Never a route
    of the port's wrapper at head dims 64 and 128."""
    import torch
    from repro_torch.kernels.build import check_launch
    from repro_torch.kernels.flash_attention import kernel as fmod
    out = torch.empty_like(q3)
    bh, sq, d = q3.shape
    err = fmod.LIBRARY.load().flash_attention_bf16(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), None,
        bh, sq, k3.shape[1], d, group, d ** -0.5, 1, 0, 0,
        torch.cuda.current_stream().cuda_stream)
    check_launch("flash_attention (simt, bf16)", err)
    return out


def sdpa_call(q, k, v, causal: bool, window):
    """SDPA on the same inputs and mask (a window as a boolean mask, True
    = attend, right-aligned queries); returns (the call, its name)."""
    import torch
    import torch.nn.functional as F
    sq, sk = q.shape[2], k.shape[2]
    if window is None:
        if causal and sq != sk:
            raise ValueError("SDPA's is_causal aligns queries left")
        return (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)), "sdpa"
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    keep = (kpos <= qpos) & (kpos > qpos - window)
    return (lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=keep, enable_gqa=True)), "sdpa with a bool mask"


def flash_kernel_phase(dev) -> dict:
    """Flash kernel vs its plain version on edge cases and at every served
    shape (there also by relative RMS error, on the wgmma route); at each
    served shape times the kernel in turns with SDPA by CUDA-graph replay
    and back to back, beside the plain version and the bound, and at
    Llama's also the f32 (simt) route and the CUDA-core kernel on bf16."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, b, hq, hkv, sq, sk, d, dtype, causal, window
        ("prefill f32", BATCH, 32, 8, PROMPT, PROMPT, 64, f32, True, None),
        ("right-aligned Sq<Sk", 2, 32, 8, 96, PROMPT, 64, bf16, True, None),
        ("window 256", 1, 32, 8, 1024, 1024, 64, bf16, True, 256),
        ("unaligned Sq, Sk", 1, 12, 4, 1000, 1037, 64, bf16, True, None),
        ("Hq == Hkv", 2, 8, 8, 300, 300, 64, bf16, True, None),
        ("not causal d=128", 2, 8, 2, 200, 333, 128, bf16, False, None),
        ("rows without keys", 1, 8, 2, 300, 100, 64, bf16, True, None),
    ]
    g = torch.Generator(device=dev).manual_seed(21)
    errs = {"wgmma": 0.0, "simt": 0.0}
    for case in cases:
        check, inputs = flash_check(dev, g, *case)
        route = fmod.route(case[7], case[6], dev)
        errs[route] = max(errs[route], check["max_abs_err"])
        del inputs
    by_shape = {}
    for name, hq, hkv, sq, sk, causal, window in FLASH_SERVED:
        before = dict(fmod.LAUNCHES_BY_ROUTE)
        check, (q, k, v) = flash_check(dev, g, name, BATCH, hq, hkv, sq, sk,
                                       64, bf16, causal, window,
                                       rel_tol=FLASH_REL_RMS_TOL)
        moved = {r: fmod.LAUNCHES_BY_ROUTE[r] - before[r] for r in before}
        if moved != {"wgmma": 1, "simt": 0}:
            raise AssertionError(f"flash {name}: launches by route {moved}")
        errs["wgmma"] = max(errs["wgmma"], check["max_abs_err"])
        t0 = time.perf_counter()
        q3, k3, v3 = (t.reshape(-1, t.shape[2], 64) for t in (q, k, v))
        group = hq // hkv
        sdpa, library = sdpa_call(q, k, v, causal, window)
        fns = (lambda: fmod.flash_attention_kernel(
            q3, k3, v3, group=group, causal=causal, window=window), sdpa)
        # device time by graph replay (whisper's calls take tens of
        # microseconds, near the host's cost of a launch), and back to back
        (ms, lib), turns = in_turns(lambda fn: graph_ms(fn, reps=50), fns)
        (b2b, lib_b2b), turns_b2b = in_turns(cuda_ms, fns)
        plain = cuda_ms(lambda: flash_attention_plain(
            q3, k3, v3, group, causal=causal, window=window), reps=5,
            warmup=1)
        bnd, by = flash_bound(BATCH, hq, hkv, sq, sk, 64, causal, window, 2)
        by_shape[name] = {"q": list(q.shape), "kv": list(k.shape),
                          "causal": causal, "window": window,
                          "route": "wgmma", **check, "ms": ms,
                          "timed": "CUDA graph replay",
                          "back_to_back_ms": b2b, "plain_ms": plain,
                          "library_ms": lib,
                          "library_back_to_back_ms": lib_b2b,
                          "library": library, "bound_ms": bnd,
                          "bound_by": by}
        extra = ""
        if name == "llama3.2-1b":
            simt = cuda_ms(lambda: flash_simt_bf16(q3, k3, v3, group),
                           reps=5, warmup=1)
            qf, kf, vf = (t.float() for t in (q3, k3, v3))
            f32_ms = cuda_ms(lambda: fmod.flash_attention_kernel(
                qf, kf, vf, group=group), reps=5, warmup=1)
            f32_plain = cuda_ms(lambda: flash_attention_plain(qf, kf, vf,
                                                              group),
                                reps=5, warmup=1)
            f32_bnd, f32_by = flash_bound(BATCH, hq, hkv, sq, sk, 64, True,
                                          None, 4)
            by_shape[name]["simt_bf16_ms"] = simt
            f32_rec = {"route": "simt", "ms": f32_ms, "plain_ms": f32_plain,
                       "bound_ms": f32_bnd, "bound_by": f32_by}
            extra = (f" simt_bf16_ms={simt:.4f} f32_simt_ms={f32_ms:.4f} "
                     f"f32_plain_ms={f32_plain:.4f} f32_bound_ms="
                     f"{f32_bnd:.4f}")
            del qf, kf, vf
        phase(f"flash timing {name}", t0,
              f"q={tuple(q.shape)} kv={tuple(k.shape)} bf16 causal="
              f"{causal} window={window} graph: kernel_ms={ms:.5f} "
              f"sdpa_ms={lib:.5f} in_turns={['%.5f' % v for v in turns]}; "
              f"back to back: kernel_ms={b2b:.5f} sdpa_ms={lib_b2b:.5f} "
              f"in_turns={['%.5f' % v for v in turns_b2b]}; plain_ms="
              f"{plain:.4f} bound_ms={bnd:.5f} ({by}) share_of_bound="
              f"{bnd / ms:.3f} pairs_per_head="
              f"{flash_pairs(sq, sk, causal, window)} last_key_tile="
              f"{sk - FLASH_KEY_TILE * ((sk - 1) // FLASH_KEY_TILE)} keys"
              + extra)
        del q, k, v, q3, k3, v3
    main = by_shape["llama3.2-1b"]
    return {"name": "flash_attention", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "launches": None, "max_abs_err": max(errs.values()),
            "ms": main["ms"], "timed": "CUDA graph replay",
            "back_to_back_ms": main["back_to_back_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "max_abs_err_by_route": errs, "served_shapes": by_shape,
            "f32": f32_rec}


def served_shape_launches(flash_rec: dict) -> None:
    """Each served shape's launches by path, from flash's counts by shape
    read on every path of this run; raises for a served shape that no
    path launched."""
    for name, hq, hkv, sq, sk, causal, window in FLASH_SERVED:
        key = flash_shape(BATCH, hq, hkv, sq, sk, causal, window)
        by_path = {path: got[key] for path, got in FLASH_SHAPES.items()
                   if got.get(key)}
        if not by_path:
            raise AssertionError(f"flash served shape {name} {key}: no "
                                 f"path launched it")
        flash_rec["served_shapes"][name]["launches_by_path"] = by_path


def rms_by_mode(x, w, eps: float, mode: int):
    """One bf16 RMSNorm launch through the C entry with its path named
    (1: the two-pass loop that bf16 rows of width 2048 took before the
    one-pass path, to which the wrapper now sends them), to be timed
    beside the wrapper."""
    import torch
    from repro_torch.kernels.build import check_launch
    from repro_torch.kernels.rmsnorm import kernel as rmod
    out = torch.empty_like(x)
    err = rmod.LIBRARY.load().rmsnorm_bf16(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
        eps, mode, torch.cuda.current_stream().cuda_stream)
    check_launch(f"rmsnorm (mode {mode})", err)
    return out


def rms_kernel_phase(dev, d_model: int) -> dict:
    """RMSNorm kernel vs its plain version at the prefill's and a decode
    step's rows and on edge cases; times kernel, plain version and
    ``F.rms_norm`` and the two-pass loop that the one-pass path replaced,
    in turns, by their device time (CUDA graph replay), at the prefill's
    and a decode step's rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as rmod
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    bf16, f32 = torch.bfloat16, torch.float32
    rows = BATCH * PROMPT
    cases = [("prefill rows", rows, d_model, bf16, "one_pass"),
             ("decode rows", BATCH, d_model, bf16, "one_pass"),
             ("prefill rows f32", rows, d_model, f32, "one_pass"),
             ("hymba rows d=1600", rows, 1600, bf16, "one_pass"),
             ("d=8192", 64, 8192, bf16, "one_pass"),
             ("d=2050 (no 16-byte path)", 64, d_model + 2, bf16, "loop"),
             ("d=100", 33, 100, bf16, "loop"),
             ("d=1000 f32", 7, 1000, f32, "one_pass")]
    g = torch.Generator(device=dev).manual_seed(22)
    errs = {}
    for name, r, d, dt, want_path in cases:
        t0 = time.perf_counter()
        x = torch.randn((r, d), device=dev, generator=g).to(dt)
        # norm scales near 1, as a model's: |out| < 8
        w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dt)
        before = dict(rmod.LAUNCHES_BY_PATH)
        got = rmod.rmsnorm_kernel(x, w, 1e-6)
        torch.cuda.synchronize()
        moved = {p: rmod.LAUNCHES_BY_PATH[p] - before[p] for p in before}
        if moved != {p: int(p == want_path) for p in moved}:
            raise AssertionError(f"rmsnorm {name}: launches by path "
                                 f"{moved}, expected one on {want_path}")
        want = rmsnorm_ref(x.float(), w.float(), 1e-6)
        err_t = (got.float() - want).abs()
        tol = RMS_TOL[str(dt)]
        # f32: 1e-6 abs plus 1e-6 relative (rsqrtf and the warp's
        # summation order each move the statistic by ~1 ulp)
        rtol = 1e-6 if dt == f32 else 0.0
        ok = bool((err_t <= tol + rtol * want.abs()).all())
        err = float(err_t.max())
        if got.dtype != dt or not ok:
            raise AssertionError(f"rmsnorm {name}: max abs err {err} vs "
                                 f"tolerance {tol} + {rtol} rel")
        errs[name] = err
        phase(f"rmsnorm check {name}", t0,
              f"x={tuple(x.shape)} {dt} path={want_path} max_abs_err={err}"
              f" tol={tol} rtol={rtol}")
    t0 = time.perf_counter()
    x = torch.randn((rows, d_model), device=dev, generator=g).to(bf16)
    w = (1 + 0.1 * torch.randn(d_model, device=dev, generator=g)).to(bf16)
    xd = x[:BATCH].contiguous()
    (ms, lib_ms, two_ms), t = in_turns(graph_ms, (
        lambda: rmod.rmsnorm_kernel(x, w, 1e-6),
        lambda: F.rms_norm(x, (d_model,), w, 1e-6),
        lambda: rms_by_mode(x, w, 1e-6, 1)))
    plain = cuda_ms(lambda: rmsnorm_ref(x, w, 1e-6))
    (dec, dec_lib, dec_two), t_dec = in_turns(graph_ms, (
        lambda: rmod.rmsnorm_kernel(xd, w, 1e-6),
        lambda: F.rms_norm(xd, (d_model,), w, 1e-6),
        lambda: rms_by_mode(xd, w, 1e-6, 1)))
    bnd, by = rms_bound(rows, d_model, 2)
    phase("rmsnorm timing (device time from CUDA graphs)", t0,
          f"prefill rows x={tuple(x.shape)} bf16: kernel_ms={ms:.5f} "
          f"rms_norm_ms={lib_ms:.5f} two_pass_ms={two_ms:.5f} plain_ms="
          f"{plain:.4f} bound_ms={bnd:.5f} ({by}) share_of_bound="
          f"{bnd / ms:.3f} in_turns={['%.5f' % v for v in t]}; decode "
          f"rows {tuple(xd.shape)}: kernel_ms={dec:.5f} rms_norm_ms="
          f"{dec_lib:.5f} two_pass_ms={dec_two:.5f} in_turns="
          f"{['%.5f' % v for v in t_dec]}")
    return {"name": "rmsnorm", "route": "cuda", "source": RMS_SOURCE,
            "replaces": RMS_REPLACES, "launches": None,
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "two_pass_ms": two_ms, "timed": "CUDA graph replay",
            "decode_rows": {"ms": dec, "library_ms": dec_lib,
                            "two_pass_ms": dec_two}}


def max_abs_diff(a, b) -> float:
    """max |a - b| in f32, one batch row at a time (logits are GBs)."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def max_abs(a) -> float:
    return max(float(x.float().abs().max()) for x in a)


def inputs_of(run) -> dict:
    """The serving batch's inputs beside the tokens: ``patch_embeds``
    (vlm) or ``frames`` (audio)."""
    return {k: v for k, v in run.batch.items() if k != "tokens"}


def patch_positions(cfg) -> int:
    """Positions the vlm family prepends to the text (0 for the others)."""
    return cfg.num_patches if cfg.family == "vlm" else 0


def check_run(run, cfg, prompt: Optional[int] = None) -> None:
    """The serving run's logits are finite of the prompt's shape (PROMPT
    tokens unless ``prompt`` says, and vlm's patch positions) and its GEN
    tokens lie in the vocabulary."""
    import torch
    prompt, gen = prompt or PROMPT, GEN
    want = (BATCH, patch_positions(cfg) + prompt, cfg.vocab_size)
    if run.logits.shape != want or \
            not bool(torch.isfinite(run.logits).all()):
        raise AssertionError(f"prefill logits are not finite of shape "
                             f"{want}")
    if run.generated.shape != (BATCH, gen) or \
            not ((run.generated >= 0) & (run.generated < cfg.vocab_size)
                 ).all():
        raise AssertionError(f"generated tokens {run.generated.shape}")


def warm_repeat(run, steps: int = 8) -> tuple:
    """Warm walls of the same prefill and of ``steps`` decode steps;
    returns (prefill s, decode s per token)."""
    import torch
    t0 = time.perf_counter()
    max_len = run.logits.shape[1] + run.generated.shape[1]
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, cache = run.model.prefill(run.params, run.batch, max_len)
        torch.cuda.synchronize()
        warm_prefill = time.perf_counter() - t1
        tok = torch.from_numpy(run.generated[:, 0]).to(
            run.batch["tokens"].device)
        t1 = time.perf_counter()
        for _ in range(steps):
            _, cache = run.model.decode_step(run.params, cache, tok)
        torch.cuda.synchronize()
        warm_decode = (time.perf_counter() - t1) / steps
        del cache
    phase("serve warm repeat", t0,
          f"prefill_ms={warm_prefill * 1e3:.3f} "
          f"decode_ms_per_token={warm_decode * 1e3:.3f}")
    return warm_prefill, warm_decode


def teacher_forced(run, forward_tokens: int = TEACHER_FORCED,
                   launches: Optional[dict] = None) -> None:
    """Teacher-forced decode equals the forward pass on the same tokens,
    to LOGIT_TOL_FRAC of the largest |logit|.  The forward pass takes the
    prompt and the first ``forward_tokens`` generated tokens; the first
    TEACHER_FORCED of those are decoded.  The prefill's logits are held
    to the forward's at the positions it keeps (the last ones).  ``launches`` (keywords of
    :func:`read_launches`) reads every launch counter around the forward
    pass."""
    import torch
    t0 = time.perf_counter()
    prompt = run.batch["tokens"].shape[1]
    # vlm's patch positions (none where the prefill keeps fewer logits)
    p = max(run.logits.shape[1] - prompt, 0)
    forced = torch.from_numpy(run.generated[:, :forward_tokens]).to(
        run.batch["tokens"].device)
    toks = torch.cat([run.batch["tokens"], forced], dim=1)
    extra = inputs_of(run)
    with torch.no_grad():
        if launches is not None:
            reset_launches()
        full = run.model.forward(run.params, {"tokens": toks, **extra})
        if launches is not None:
            read_launches(**launches)
        lg, cache = run.model.prefill(
            run.params, {"tokens": toks[:, :prompt], **extra},
            p + prompt + TEACHER_FORCED)
        errs = [max_abs_diff(full[:, p + prompt - lg.shape[1]:p + prompt],
                             lg)]
        del lg
        for t in range(TEACHER_FORCED):
            lg, cache = run.model.decode_step(run.params, cache,
                                              toks[:, prompt + t])
            errs.append(float((full[:, p + prompt + t].float()
                               - lg.float()).abs().max()))
    scale = max_abs(full)
    del full, cache
    if not max(errs) <= LOGIT_TOL_FRAC * scale:
        raise AssertionError(f"teacher-forced decode differs from forward: "
                             f"{errs} (> {LOGIT_TOL_FRAC} x {scale})")
    phase("teacher-forced decode vs forward", t0,
          f"forward tokens={toks.shape[1]} max_abs_diff prefill/steps="
          f"{errs} max_abs_logit={scale} tol={LOGIT_TOL_FRAC * scale}")


def serve_smoke(arch: str, seed: int, expect: dict,
                prompt: Optional[int] = None, extra: str = "", **read_kw):
    """``serve --model-smoke --arch arch`` at batch BATCH, ``prompt``
    tokens and GEN greedy tokens, every launch counter read around it
    (``expect``: the whole request's launches by kernel; ``read_kw`` goes
    to :func:`read_launches`); prints the reference's lines and a phase
    line with ``extra`` in it; returns (run, launches)."""
    import torch
    from repro_torch.launch import serve
    prompt = prompt or PROMPT
    argv = ["--model-smoke", "--arch", arch, "--batch", str(BATCH),
            "--prompt-len", str(prompt), "--gen", str(GEN), "--seed",
            str(seed), "--device", "cuda"]
    args = serve.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launches()
    run = serve.model_smoke(args)
    launches = read_launches(arch, expect, **read_kw)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in serve.report_lines(args, run):
        print(line, flush=True)
    inputs = {k: list(v.shape) for k, v in inputs_of(run).items()}
    phase("serve --model-smoke", t0,
          f"arch={arch} {extra + ' ' if extra else ''}params="
          f"{sum(p.numel() for p in run.params.parameters())} batch="
          f"{BATCH} prompt={prompt} inputs={json.dumps(inputs)} "
          f"gen={GEN} prefill_ms={run.prefill_s * 1e3:.3f} "
          f"decode_ms_per_token={run.decode_s_per_token * 1e3:.3f} "
          f"peak_mem_gb={peak_gb:.3f} launches={json.dumps(launches)}")
    return run, launches


def plain_attention_prefill(run, cfg) -> None:
    """The same prefill through plain attention (``attn_impl="ref"``) on
    the same weights and inputs: logits within LOGIT_TOL_FRAC of the
    largest |logit|."""
    import torch
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    plain_model = build_model(cfg.scaled(attn_impl="ref"),
                              device=run.batch["tokens"].device)
    with torch.no_grad():
        plain_logits, _ = plain_model.prefill(run.params, run.batch,
                                              run.logits.shape[1])
    diff = max_abs_diff(run.logits, plain_logits)
    scale = max_abs(plain_logits)
    del plain_logits
    if not diff <= LOGIT_TOL_FRAC * scale:
        raise AssertionError(f"kernel-path logits differ from the plain "
                             f"path by {diff} (> {LOGIT_TOL_FRAC} x "
                             f"{scale})")
    phase("prefill kernel vs plain attention", t0,
          f"max_abs_diff={diff} max_abs_logit={scale} "
          f"tol={LOGIT_TOL_FRAC * scale}")


def lm_slice(seed: int) -> list:
    """Kernel checks, then the serving path at Llama-3.2-1B's full width;
    returns the flash and RMSNorm kernels' JSON records."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import apply_rmsnorm, embed_tokens

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    flash_rec = flash_kernel_phase(dev)
    rms_rec = rms_kernel_phase(dev, cfg.d_model)
    torch.cuda.empty_cache()

    # the main path: the serving entry, every launch counter read around
    # it; one flash launch per layer
    run, launches = serve_smoke(
        ARCH, seed, {"flash_attention": cfg.num_layers},
        extra=f"layers={cfg.num_layers}", flash_shapes={flash_shape(
            BATCH, cfg.num_heads, cfg.num_kv_heads, PROMPT, PROMPT, True,
            None): cfg.num_layers})
    check_run(run, cfg)
    flash_rec["launches"] = launches["flash_attention"]
    flash_rec["launches_by_route"] = FLASH_ROUTES[ARCH]
    warm_repeat(run)

    plain_attention_prefill(run, cfg)
    teacher_forced(run)
    forced = torch.from_numpy(run.generated[:, :1]).to(dev)

    # RMSNorm's route: layers.apply_rmsnorm(use_kernel=True), on the
    # serving path's hidden-state shapes (the model's own apply_norm
    # keeps the plain version, as the reference does)
    t0 = time.perf_counter()
    with torch.no_grad():
        x_pre = embed_tokens(run.params["embed"], run.batch["tokens"],
                             cfg)
        x_dec = embed_tokens(run.params["embed"], forced[:, :1], cfg)
        norm = run.params["final_norm"]
        reset_launches()
        y_pre = apply_rmsnorm(norm, x_pre, cfg.norm_eps, use_kernel=True)
        y_dec = apply_rmsnorm(norm, x_dec, cfg.norm_eps, use_kernel=True)
        rms_launches = read_launches("apply_rmsnorm(use_kernel=True)",
                                     {"rmsnorm": 2})["rmsnorm"]
        err = max(float((y.float() - apply_rmsnorm(
            norm, x.float(), cfg.norm_eps).float()).abs().max())
            for x, y in ((x_pre, y_pre), (x_dec, y_dec)))
    if not err < RMS_TOL["torch.bfloat16"]:
        raise AssertionError(f"apply_rmsnorm(use_kernel=True): err {err}")
    rms_rec["launches"] = rms_launches
    rms_rec["path"] = ("models.layers.apply_rmsnorm(use_kernel=True) on "
                       "the prefill's and a decode step's hidden states")
    phase("apply_rmsnorm(use_kernel=True)", t0,
          f"x={tuple(x_pre.shape)},{tuple(x_dec.shape)} launches="
          f"{rms_launches} max_abs_err={err}")
    return [flash_rec, rms_rec]


# ---------------------------------------------------------------------------
# slices 2b and 2c: internvl2-1b (vlm) and whisper-base (encoder-decoder)
# serving at full width and depth
# ---------------------------------------------------------------------------


def prefill_and_step_launches(run, arch: str, prefill: dict,
                              flash_shapes: dict) -> None:
    """One prefill and one decode step apart, each with every launch
    counter read around it: ``prefill`` the prefill's launches by kernel
    and ``flash_shapes`` flash's by shape, none in the step."""
    import torch
    t0 = time.perf_counter()
    with torch.no_grad():
        reset_launches()
        _, cache = run.model.prefill(run.params, run.batch,
                                     run.logits.shape[1] + 1)
        read_launches(f"{arch} prefill", prefill, flash_shapes=flash_shapes)
        reset_launches()
        run.model.decode_step(run.params, cache, torch.from_numpy(
            run.generated[:, 0]).to(run.batch["tokens"].device))
        read_launches(f"{arch} decode step", {})
        del cache
    phase("prefill and decode step launches", t0,
          f"prefill {json.dumps(prefill)}; decode step none")


def vlm_slice(seed: int) -> None:
    """internvl2-1b serving at full width and depth: batch BATCH, 256
    random patch embeddings projected and prepended to a PROMPT-token
    prompt, GEN greedy tokens; one flash launch per layer (all wgmma),
    in the prefill alone."""
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH)
    L = cfg.num_layers
    s = cfg.num_patches + PROMPT
    shapes = {flash_shape(BATCH, cfg.num_heads, cfg.num_kv_heads, s, s,
                          True, None): L}
    run, _ = serve_smoke(VLM_ARCH, seed, {"flash_attention": L},
                         flash_shapes=shapes)
    params = sum(p.numel() for p in run.params.parameters())
    if params != VLM_PARAMS:
        raise AssertionError(f"{params} parameters, expected {VLM_PARAMS}")
    check_run(run, cfg)
    if run.cache.pos != cfg.num_patches + PROMPT + GEN - 1 or \
            run.cache.k.shape[3] != cfg.num_patches + PROMPT + GEN:
        raise AssertionError(f"cache position {run.cache.pos}, length "
                             f"{run.cache.k.shape[3]}")
    warm_repeat(run)
    prefill_and_step_launches(run, VLM_ARCH, {"flash_attention": L},
                              shapes)
    plain_attention_prefill(run, cfg)
    teacher_forced(run)


def audio_slice(seed: int) -> None:
    """whisper-base serving at full width and depth: batch BATCH, 1,500
    random encoder frames, an AUDIO_PROMPT-token prompt and GEN greedy
    tokens (the decoder's 448 positions); one flash launch per encoder
    layer in the prefill and none in a decode step (the decoder's
    attention keeps the reference's plain choices); the teacher-forced
    forward over all 448 tokens runs the kernel in every encoder layer and
    twice in every decoder layer (self and cross attention)."""
    from repro_torch.configs import get_config
    cfg = get_config(AUDIO_ARCH)
    enc, dec = cfg.encoder_layers, cfg.num_layers
    hq, hkv, frames = cfg.num_heads, cfg.num_kv_heads, cfg.encoder_seq
    encoder = {flash_shape(BATCH, hq, hkv, frames, frames, False, None):
               enc}
    run, _ = serve_smoke(AUDIO_ARCH, seed, {"flash_attention": enc},
                         prompt=AUDIO_PROMPT, flash_shapes=encoder)
    params = sum(p.numel() for p in run.params.parameters())
    if params != AUDIO_PARAMS:
        raise AssertionError(f"{params} parameters, expected "
                             f"{AUDIO_PARAMS}")
    check_run(run, cfg, prompt=AUDIO_PROMPT)
    if any(c["self"].pos != AUDIO_CONTEXT - 1
           or c["self"].k.shape[2] != AUDIO_CONTEXT
           or c["cross_k"].shape[2] != cfg.encoder_seq for c in run.cache):
        raise AssertionError("whisper caches: self positions "
                             f"{[c['self'].pos for c in run.cache]}")
    warm_repeat(run)
    prefill_and_step_launches(run, AUDIO_ARCH, {"flash_attention": enc},
                              encoder)
    plain_attention_prefill(run, cfg)
    # the forward: the encoder, then each decoder layer's self attention
    # (causal) and cross attention to the frames
    teacher_forced(run, forward_tokens=GEN, launches=dict(
        path=f"{AUDIO_ARCH} forward",
        expect={"flash_attention": enc + 2 * dec},
        flash_shapes={**encoder, flash_shape(
            BATCH, hq, hkv, AUDIO_CONTEXT, AUDIO_CONTEXT, True, None): dec,
            flash_shape(BATCH, hq, hkv, AUDIO_CONTEXT, frames, False,
                        None): dec}))


# ---------------------------------------------------------------------------
# slice 3a: granite-moe-1b-a400m serving at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"
DISPATCH_REPLACES = "src/repro/kernels/moe_dispatch/kernel.py:50"
DISPATCH_SOURCE = "src/repro_torch/csrc/moe_dispatch.cu"


def dispatch_bound(n: int, groups: int):
    """(bound ms, by) of the dispatch
    (``repro_torch.kernels.work.dispatch``: n ids read, n positions and
    ``groups`` counts written; one compare and one add an id)."""
    from repro_torch.kernels import work
    return work.dispatch(n, groups).bound()


def sort_index_add(a, groups, ones):
    """The library's dispatch as a CUDA graph can hold it:
    ``torch.sort(stable=True)``, and the counts by ``index_add_`` of
    ``ones`` into zeros (``torch.bincount`` reads the ids' largest value
    on the host, so no graph captures it)."""
    import torch
    return (torch.sort(a, stable=True),
            torch.zeros((groups,), dtype=torch.int32,
                        device=a.device).index_add_(0, a, ones))


def dispatch_kernel_phase(dev, n_prefill: int, n_decode: int,
                          groups: int) -> dict:
    """Dispatch kernel vs its plain version, bit for bit, at the prefill's
    and a decode step's sizes and on edge cases, each asserted on its
    route (the cluster's reach and one id past it, the most groups the
    cluster route takes and one more); then, at the prefill's and a
    decode step's sizes, the cluster route and the kernel it replaced
    (the tiled route) timed in turns by graph replay and back to back, beside
    the plain version, the library and the bound."""
    import torch
    from repro_torch.kernels.moe_dispatch import kernel as dmod
    from repro_torch.kernels.moe_dispatch.ref import dispatch_ref
    g = torch.Generator(device=dev).manual_seed(31)
    reach, most = dmod.CLUSTER_REACH, dmod.CLUSTER_GROUPS

    def ids(n, lo, hi):
        return torch.randint(lo, hi, (n,), device=dev, dtype=torch.int32,
                             generator=g)

    at_reach = ids(reach, 0, groups)
    cases = [
        ("prefill", ids(n_prefill, 0, groups), groups),
        ("decode", ids(n_decode, 0, groups), groups),
        ("n=1", ids(1, 0, groups), groups),
        ("one group", ids(5000, 0, 1), 1),
        ("G=64, n=64", ids(64, 0, 64), 64),
        ("n not a multiple of the tile", ids(n_prefill + 77, 0, groups),
         groups),
        ("one hot group", torch.full((n_prefill,), 7, device=dev,
                                     dtype=torch.int32), groups),
        ("ids outside [0, G)", ids(10000, -3, groups + 3), groups),
        ("G=5000", ids(100000, 0, 5000), 5000),
        ("n=0", ids(0, 0, groups), groups),
        ("n=4097 (a second block)", ids(4097, 0, groups), groups),
        (f"n = the cluster's reach {reach}", at_reach, groups),
        ("n = reach + 1", ids(reach + 1, 0, groups), groups),
        ("one hot group at the reach", torch.full(
            (reach,), groups - 1, device=dev, dtype=torch.int32), groups),
        (f"G = {most}, ids outside", ids(30000, -5, most + 5), most),
        (f"G = {most + 1}", ids(30000, 0, most + 1), most + 1),
    ]
    for name, a, G in cases:
        t0 = time.perf_counter()
        before = (dmod.LAUNCHES, dict(dmod.LAUNCHES_BY_ROUTE))
        got = dmod.moe_dispatch_kernel(a, G)
        torch.cuda.synchronize()
        kind = dmod.route(a.numel(), G, dev)
        launched = dmod.LAUNCHES - before[0]
        by_route = {r: v - before[1][r]
                    for r, v in dmod.LAUNCHES_BY_ROUTE.items()}
        compare(f"dispatch {name}", got, dispatch_ref(a, G))
        want = 1 if a.numel() else 0
        if launched != want or by_route[kind] != want:
            raise AssertionError(f"dispatch {name}: {launched} launches, "
                                 f"by route {by_route}; expected {want} "
                                 f"on {kind}")
        phase(f"dispatch check {name}", t0,
              f"n={a.numel()} groups={G} route={kind} bit-equal to plain "
              f"version")
    t0 = time.perf_counter()
    for name, a, G in cases[:2]:
        compare(f"dispatch tiled kernel {name}", dmod.tiled_launch(a, G),
                dispatch_ref(a, G))
    torch.cuda.synchronize()
    width = dmod.LIBRARY.load().moe_dispatch_cluster_width()
    phase("dispatch check tiled kernel", t0,
          f"prefill and decode bit-equal to plain version; widest "
          f"cluster on this card: {width} blocks")

    times = {}
    for what, a in (("prefill", cases[0][1]), ("decode", cases[1][1])):
        t0 = time.perf_counter()
        ones = torch.ones_like(a)
        fns = (lambda: dmod.moe_dispatch_kernel(a, groups),
               lambda: dmod.tiled_launch(a, groups))
        (ms, parent), t_graph = in_turns(graph_ms, fns)
        (b2b, parent_b2b), t_b2b = in_turns(cuda_ms, fns)
        plain = cuda_ms(lambda: dispatch_ref(a, groups))
        lib = graph_ms(lambda: sort_index_add(a, groups, ones))
        lib_b2b = cuda_ms(lambda: (torch.sort(a, stable=True),
                                   torch.bincount(a, minlength=groups)))
        bnd, by = dispatch_bound(a.numel(), groups)
        times[what] = (ms, parent, b2b, parent_b2b, plain, lib, lib_b2b,
                       bnd, by)
        phase(f"dispatch timing {what}", t0,
              f"n={a.numel()} groups={groups} cluster graph_ms={ms:.5f} "
              f"tiled (replaced) graph_ms={parent:.5f} in_turns="
              f"{['%.5f' % v for v in t_graph]}; back_to_back cluster="
              f"{b2b:.5f} tiled={parent_b2b:.5f} in_turns="
              f"{['%.5f' % v for v in t_b2b]}; plain_ms={plain:.4f}; "
              f"sort+index_add_ graph_ms={lib:.5f}; sort+bincount "
              f"back_to_back_ms={lib_b2b:.5f}; bound_ms={bnd:.7f} ({by})")
    # the cluster route at its reach, where no ported path goes: graph
    # replay only, in turns with the tiled kernel
    t0 = time.perf_counter()
    (reach_ms, reach_parent), t_graph = in_turns(graph_ms, (
        lambda: dmod.moe_dispatch_kernel(at_reach, groups),
        lambda: dmod.tiled_launch(at_reach, groups)))
    phase("dispatch timing at the reach", t0,
          f"n={reach} groups={groups} cluster graph_ms={reach_ms:.5f} "
          f"tiled graph_ms={reach_parent:.5f} in_turns="
          f"{['%.5f' % v for v in t_graph]}")
    ms, parent, b2b, parent_b2b, plain, lib, lib_b2b, bnd, by = \
        times["prefill"]
    dec = times["decode"]
    return {"name": "moe_dispatch", "route": "cuda",
            "source": DISPATCH_SOURCE, "replaces": DISPATCH_REPLACES,
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "timed": "CUDA graph replay", "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib,
            "library": "torch.sort(stable=True) + index_add_ counts (graph "
                       "replay; torch.bincount cannot be captured)",
            "back_to_back_ms": b2b, "parent_kernel_ms": parent,
            "parent_kernel_back_to_back_ms": parent_b2b,
            "library_back_to_back_ms": lib_b2b,
            "library_back_to_back": "torch.sort(stable=True) + "
                                    "torch.bincount",
            "cluster_blocks": width,
            "decode_ms": dec[0], "decode_parent_kernel_ms": dec[1],
            "decode_back_to_back_ms": dec[2],
            "decode_parent_kernel_back_to_back_ms": dec[3],
            "decode_plain_ms": dec[4], "decode_library_ms": dec[5],
            "decode_bound_ms": dec[7], "reach_ms": reach_ms,
            "reach_parent_kernel_ms": reach_parent}


def recording(fn, log: list):
    """``fn`` (a dispatch) that also appends (ids, positions, counts) of
    every call to ``log``."""
    def dispatch(assignments, num_groups):
        positions, counts = fn(assignments, num_groups)
        log.append((assignments.reshape(-1).to(positions.dtype),
                    positions, counts))
        return positions, counts
    return dispatch


def moe_slice(seed: int) -> dict:
    """Dispatch kernel checks, then MoE serving at granite's full width;
    returns the dispatch kernel's JSON record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_dispatch.ref import dispatch_ref
    from repro_torch.models import moe as moe_lib

    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH)
    k, E, L = cfg.experts_per_token, cfg.num_experts, cfg.num_layers
    rec = dispatch_kernel_phase(dev, BATCH * PROMPT * k, BATCH * k, E)
    torch.cuda.empty_cache()

    # the main path: the serving entry, every launch counter read around it
    # one dispatch per layer in the prefill and in each of GEN - 1 decode
    # steps; one flash launch per layer in the prefill
    run, launches = serve_smoke(
        MOE_ARCH, seed, {"moe_dispatch": L * GEN, "flash_attention": L},
        extra=f"layers={L} experts={E} top_k={k}")
    check_run(run, cfg)
    rec["launches"] = launches["moe_dispatch"]
    warm_repeat(run)

    # one prefill and one decode step apart, with the dispatch's inputs and
    # outputs recorded; then the same prefill through its plain version
    t0 = time.perf_counter()
    kernel_log, plain_log = [], []
    kernel_dispatch = moe_lib.moe_dispatch
    try:
        moe_lib.moe_dispatch = recording(kernel_dispatch, kernel_log)
        with torch.no_grad():
            reset_launches()
            logits, cache = run.model.prefill(
                run.params, run.batch, PROMPT + 1)
            read_launches(f"{MOE_ARCH} prefill", {"moe_dispatch": L,
                                                  "flash_attention": L})
            reset_launches()
            run.model.decode_step(run.params, cache, torch.from_numpy(
                run.generated[:, 0]).to(dev))
            read_launches(f"{MOE_ARCH} decode step", {"moe_dispatch": L})
            del cache
            moe_lib.moe_dispatch = recording(
                lambda a, G: dispatch_ref(a.reshape(-1).to(torch.int32), G),
                plain_log)
            plain_logits, _ = run.model.prefill(
                run.params, run.batch, PROMPT)
    finally:
        moe_lib.moe_dispatch = kernel_dispatch
    kernel_log = kernel_log[:L]              # the prefill's layers
    if len(kernel_log) != L or len(plain_log) != L:
        raise AssertionError(f"{len(kernel_log)} / {len(plain_log)} "
                             f"dispatch calls, expected {L}")
    for layer, (kc, pc) in enumerate(zip(kernel_log, plain_log)):
        for what, a, b in zip(("ids", "positions", "counts"), kc, pc):
            if not torch.equal(a, b):
                raise AssertionError(f"layer {layer}: dispatch {what} of "
                                     f"the kernel path != plain path")
    bit_equal = torch.equal(logits, plain_logits)
    diff = max_abs_diff(logits, plain_logits)
    scale = max_abs(plain_logits)
    del logits, plain_logits
    # the dispatch is integer: with equal ids, positions and counts in
    # every layer, every float op downstream sees the same inputs
    if not bit_equal:
        raise AssertionError(f"kernel-path logits differ from the plain "
                             f"dispatch's by {diff} (max |logit| {scale})")
    phase("prefill dispatch kernel vs plain version", t0,
          f"layers={L} ids/positions/counts equal in every layer; logits "
          f"bit-equal (max_abs_diff={diff}, max_abs_logit={scale}); "
          f"tokens_per_expert_layer0="
          f"{plain_log[0][2].tolist()}")

    teacher_forced(run)
    return rec


# ---------------------------------------------------------------------------
# slice 3b: the paper's virtual-screening pipeline
# ---------------------------------------------------------------------------

VS_MOLECULES = 2_097_152         # 8 shards of 262,144
VS_TOP, VS_ROUNDS, VS_DEPTH = 30, 8, 2
FEATURES = 16
TOPK_REPLACES = "src/repro/kernels/topk_reduce/kernel.py:72"
TOPK_SOURCE = "src/repro_torch/csrc/topk_reduce.cu"


def fred_mix(r: int):
    """Round ``r``'s [16, 16] mixing matrix, as ``benchmarks/apps.py``
    draws it."""
    import torch
    rng = np.random.default_rng(r)
    return torch.from_numpy(
        (rng.normal(size=(FEATURES, FEATURES)) / np.sqrt(FEATURES)
         ).astype(np.float32))


def fred_score(feats, rounds: int = VS_ROUNDS):
    """The surrogate docking score: x = tanh(x @ mix_r) + 0.1 x for
    ``rounds`` rounds, then the sum of the features."""
    import torch
    x = feats.float()
    for r in range(rounds):
        x = torch.tanh(x @ fred_mix(r).to(x.device)) + 0.1 * x
    return torch.sum(x, dim=-1)


def register_fred() -> None:
    """The ``tools/fred`` image of ``benchmarks/apps.py`` in the port's
    registry: (features, molecule id) -> (score, molecule id)."""
    from repro_torch.core.container import (DEFAULT_REGISTRY, container_op,
                                            make_partition)
    if "tools/fred:latest" in DEFAULT_REGISTRY.images():
        return

    @container_op("tools/fred", registry=DEFAULT_REGISTRY)
    def fred(part, command: str = "", rounds: int = VS_ROUNDS, **kw):
        feats, mol_id = part.records
        return make_partition((fred_score(feats, rounds), mol_id),
                              part.count)


def make_library(n: int, seed: int):
    """n molecules: ([n, 16] float32 features, [n] int32 ids), as
    ``benchmarks/apps.py:make_library``."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, FEATURES)).astype(np.float32)
    return feats, np.arange(n, dtype=np.int32)


def virtual_screening(data, num_shards: int = 1, device=None,
                      top: int = VS_TOP, rounds: int = VS_ROUNDS,
                      depth: int = VS_DEPTH):
    """Paper Listing 2 on the port: map(tools/fred) -> reduce(toolbox/
    topk); ``data`` is the library or a dataset.  Returns the lazy chain."""
    from repro_torch.core import MaRe, TextFile
    register_fred()
    sdf = ("/in.sdf", "/out.sdf")
    return (MaRe(data, num_shards=num_shards, device=device)
            .map(input_mount=TextFile(sdf[0], "\n$$$$\n"),
                 output_mount=TextFile(sdf[1], "\n$$$$\n"),
                 image="tools/fred", rounds=rounds)
            .reduce(input_mount=TextFile(sdf[0], "\n$$$$\n"),
                    output_mount=TextFile(sdf[1], "\n$$$$\n"),
                    image="toolbox/topk", k=top, depth=depth))


def topk_combines(num_shards: int, depth: int) -> int:
    """``toolbox/topk`` calls of one depth-K tree reduce: one per shard,
    then one per group leader at each level (``core/tree_reduce``)."""
    from repro_torch.core.tree_reduce import split_factors
    calls, stride = num_shards, 1
    for g in split_factors(num_shards, depth):
        if g > 1:
            calls += -(-num_shards // (stride * g))
            stride *= g
    return calls


def topk_bound(n: int, k: int):
    """(bound ms, by) of the top-k (``repro_torch.kernels.work.topk``: n
    scores read, k values and indices written; one compare a score)."""
    from repro_torch.kernels import work
    return work.topk(n, k).bound()


def special_scores(dev, n: int, seed: int):
    """n scores with NaNs of both signs, -inf, +inf and signed zeros
    among ties: the bits' total order decides them."""
    import torch
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=n) * 2) / 2
    bits = x.astype(np.float32).view(np.int32)
    bits[rng.random(n) < 0.01] = 0x7FC00000            # +NaN
    bits[rng.random(n) < 0.01] = -0x00400000           # -NaN (0xFFC00000)
    x = bits.view(np.float32)
    x[rng.random(n) < 0.05] = -0.0
    x[rng.random(n) < 0.05] = 0.0
    x[rng.random(n) < 0.01] = -np.inf
    x[rng.random(n) < 0.001] = np.inf
    return torch.from_numpy(x).to(dev)


def topk_kernel_phase(dev, n: int, k: int, tree_sizes) -> dict:
    """Top-k kernel vs its plain version, bit for bit, at a shard's size,
    at the tree combines' sizes ``tree_sizes`` and on edge cases, each
    asserted on its route (k = 32 and 33, ascending, descending and
    all-equal scores, NaNs and signed zeros); then, at a shard's and each
    tree combine's size, the select route and the kernel it replaced
    (the tree route) timed in turns by graph replay and back to back, beside
    the plain version, ``torch.topk`` and the bound."""
    import torch
    from repro_torch.kernels.topk_reduce import kernel as tmod
    from repro_torch.kernels.topk_reduce.ref import topk_ref
    g = torch.Generator(device=dev).manual_seed(41)
    s = torch.randn((n,), device=dev, generator=g)
    dup = torch.round(torch.randn((n,), device=dev, generator=g) * 4) / 4
    small = torch.randn((100,), device=dev, generator=g)
    ties = torch.tensor([1.0, float("-inf"), 0.0, -0.0, 1.0, float("-inf"),
                         2.0, 0.0], device=dev)
    asc = torch.arange(n, device=dev, dtype=torch.float32)
    special = special_scores(dev, n, 43)
    cases = [
        ("shard", s, k, n),
        ("shard, count < n", s, k, n - 12345),
        ("duplicates", dup, k, n),
        ("k > valid_count", s, k, 10),
        ("valid_count = 0", s, k, 0),
        ("k = n", small, 100, 100),
        ("n not a multiple of the tile", s[:n - 77], k, n - 1000),
        ("tree level", s[:2 * k], k, k + 7),
        ("n = 1", s[:1], 1, 1),
        ("+-0 and -inf ties", ties, 8, 7),
        ("8 shards at once", torch.randn((8 * n,), device=dev,
                                         generator=g), k, 8 * n),
        ("k = 32", s, 32, n),
        ("k = 33", s, 33, n),
        ("k = 1", s, 1, n),
        ("ascending", asc, k, n),
        ("descending", asc.flip(0).contiguous(), k, n),
        ("all equal", torch.full((n,), 0.5, device=dev), k, n),
        ("NaNs, +-inf and +-0", special, k, n),
        ("NaNs, +-inf and +-0, k = 32, count < n", special, 32, n - 999),
        ("valid_count = 0, k = 32", s[:5000], 32, 0),
        ("k = 32 = n", s[:32], 32, 32),
        ("one block's ids + 1", s[:2049], k, 2049),
    ] + [(f"tree combine n={m}", s[:m], k, m) for m in tree_sizes]
    for name, x, kk, vc in cases:
        t0 = time.perf_counter()
        vct = torch.tensor(vc, device=dev, dtype=torch.int32)
        before = (tmod.LAUNCHES, dict(tmod.LAUNCHES_BY_ROUTE))
        got = tmod.topk_reduce_kernel(x, kk, vct)
        torch.cuda.synchronize()
        kind = tmod.route(kk, x.numel(), dev)
        by_route = {r: v - before[1][r]
                    for r, v in tmod.LAUNCHES_BY_ROUTE.items()}
        if tmod.LAUNCHES - before[0] != 1 or by_route[kind] != 1:
            raise AssertionError(f"top-k {name}: "
                                 f"{tmod.LAUNCHES - before[0]} launches, "
                                 f"by route {by_route}; expected 1 on "
                                 f"{kind}")
        want = topk_ref(x, kk, vct)
        # the values' bits: NaNs and signed zeros must come out as they
        # went in
        compare(f"top-k {name}", (got[0].view(torch.int32), got[1]),
                (want[0].view(torch.int32), want[1]))
        phase(f"top-k check {name}", t0,
              f"n={x.numel()} k={kk} valid_count={vc} route={kind} "
              f"bit-equal to plain version")
    t0 = time.perf_counter()
    vct = torch.tensor(n, device=dev, dtype=torch.int32)
    compare("top-k tree kernel shard", tmod.tree_launch(s, k, vct),
            topk_ref(s, k, vct))
    phase("top-k check tree kernel", t0, "shard bit-equal to plain version")

    times = {}
    for m, x in [(n, s)] + [(m, s[:m]) for m in tree_sizes]:
        t0 = time.perf_counter()
        vct = torch.tensor(m, device=dev, dtype=torch.int32)
        fns = (lambda: tmod.topk_reduce_kernel(x, k, vct),
               lambda: tmod.tree_launch(x, k, vct))
        (ms, parent), t_graph = in_turns(graph_ms, fns)
        (b2b, parent_b2b), t_b2b = in_turns(cuda_ms, fns)
        plain = cuda_ms(lambda: topk_ref(x, k, vct))
        lib = graph_ms(lambda: torch.topk(x, k))
        lib_b2b = cuda_ms(lambda: torch.topk(x, k))
        bnd, by = topk_bound(m, k)
        times[m] = (ms, parent, b2b, parent_b2b, plain, lib, lib_b2b, bnd,
                    by)
        phase(f"top-k timing n={m}", t0,
              f"k={k} select graph_ms={ms:.5f} tree (replaced) graph_ms="
              f"{parent:.5f} in_turns={['%.5f' % v for v in t_graph]}; "
              f"back_to_back select={b2b:.5f} tree={parent_b2b:.5f} "
              f"in_turns={['%.5f' % v for v in t_b2b]}; plain_ms="
              f"{plain:.4f}; torch.topk graph_ms={lib:.5f} back_to_back_ms"
              f"={lib_b2b:.5f}; bound_ms={bnd:.7f} ({by})")
    ms, parent, b2b, parent_b2b, plain, lib, lib_b2b, bnd, by = times[n]
    return {"name": "topk_reduce", "route": "cuda", "source": TOPK_SOURCE,
            "replaces": TOPK_REPLACES, "launches": None,
            "max_abs_err": 0.0, "ms": ms, "timed": "CUDA graph replay",
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib, "library": "torch.topk (graph replay)",
            "back_to_back_ms": b2b, "parent_kernel_ms": parent,
            "parent_kernel_back_to_back_ms": parent_b2b,
            "library_back_to_back_ms": lib_b2b,
            "tree_combines": {
                str(m): {"ms": t[0], "parent_kernel_ms": t[1],
                         "back_to_back_ms": t[2],
                         "parent_kernel_back_to_back_ms": t[3],
                         "library_ms": t[5], "bound_ms": t[7]}
                for m, t in times.items() if m != n}}


def tree_combine_sizes(num_shards: int, depth: int, k: int) -> list:
    """The rows each level's ``toolbox/topk`` combine takes in a depth-K
    tree reduce: k rows of each of a group's g members
    (``core/tree_reduce``), once per distinct g."""
    from repro_torch.core.tree_reduce import split_factors
    return sorted({g * k for g in split_factors(num_shards, depth)
                   if g > 1})


def vs_slice(seed: int) -> dict:
    """Top-k kernel checks, then the virtual-screening pipeline over 2M
    molecules in 8 shards; returns the top-k kernel's JSON record."""
    import torch
    from repro_torch.core import MaRe, images
    from repro_torch.kernels.topk_reduce.ref import topk_ref

    dev = torch.device("cuda")
    shard = VS_MOLECULES // NUM_SHARDS
    sizes = tree_combine_sizes(NUM_SHARDS, VS_DEPTH, VS_TOP)
    print(f"tree combines: split_factors({NUM_SHARDS}, {VS_DEPTH}) -> "
          f"{sizes} rows", flush=True)
    rec = topk_kernel_phase(dev, shard, VS_TOP, sizes)

    t0 = time.perf_counter()
    library = make_library(VS_MOLECULES, seed)
    ds = MaRe(library, num_shards=NUM_SHARDS, device=dev).dataset
    torch.cuda.synchronize()
    phase("VS library", t0, f"molecules={VS_MOLECULES} shards="
          f"{ds.num_shards} cap={ds.capacity} features={FEATURES} "
          f"bytes={library[0].nbytes + library[1].nbytes}")

    # the main path, every launch counter read around it
    t0 = time.perf_counter()
    reset_launches()
    chain = virtual_screening(ds, top=VS_TOP)
    scores, ids = chain.collect(shard=0)
    combines = topk_combines(NUM_SHARDS, VS_DEPTH)
    launches = read_launches("virtual screening",
                             {"topk_reduce": combines})
    first = chain.report().wall_s
    rec["launches"] = launches["topk_reduce"]
    print(chain.describe(), flush=True)
    phase("VS map(tools/fred) -> reduce(toolbox/topk)", t0,
          f"top={len(ids)} action_wall_s={first:.6f} "
          f"topk_combines={combines} launches={json.dumps(launches)} "
          f"phases={json.dumps(chain.report().phases)}")
    t0 = time.perf_counter()
    warm = []
    for _ in range(3):
        again = virtual_screening(ds, top=VS_TOP)
        s2, i2 = again.collect(shard=0)
        warm.append(again.report().wall_s)
        if not (np.array_equal(s2, scores) and np.array_equal(i2, ids)):
            raise AssertionError("a warm VS action gave other records")
    phase("VS warm actions", t0, f"action_wall_s={warm}")
    # the sizes the combines really took: a shard's capacity 8 times, then
    # the tree combines' (timed above)
    t0 = time.perf_counter()
    real, calls = images.topk_reduce, []

    def sized(x, k, vc):
        calls.append(x.shape[0])
        return real(x, k, vc)

    try:
        images.topk_reduce = sized
        virtual_screening(ds, top=VS_TOP).collect(shard=0)
    finally:
        images.topk_reduce = real
    if (calls[:NUM_SHARDS] != [ds.capacity] * NUM_SHARDS
            or sorted(set(calls[NUM_SHARDS:])) != sizes):
        raise AssertionError(f"top-k calls took {calls} rows; expected "
                             f"{NUM_SHARDS} x {ds.capacity}, then {sizes}")
    phase("VS top-k call sizes", t0, f"rows in call order: {calls}")

    # records == a plain top-k over the pipeline's own mapped scores
    t0 = time.perf_counter()
    register_fred()
    mapped = MaRe(ds).map(image="tools/fred", rounds=VS_ROUNDS).dataset
    cap, cnt = mapped.capacity, mapped.counts.tolist()
    m_scores, m_ids = mapped.records
    keep = torch.cat([torch.arange(s * cap, s * cap + c, device=dev)
                      for s, c in enumerate(cnt)])
    pv, pi = topk_ref(m_scores[keep], VS_TOP)
    want_scores = pv.cpu().numpy()
    want_ids = m_ids[keep][pi.long()].cpu().numpy()
    if not (np.array_equal(scores, want_scores)
            and np.array_equal(ids, want_ids)):
        raise AssertionError("VS records != plain top-k of the pipeline's "
                             "mapped scores")
    # ... and the oracle: score the whole library at once, stable sort
    feats = torch.from_numpy(library[0]).to(dev)
    all_scores = fred_score(feats)
    order = torch.sort(all_scores, descending=True, stable=True).indices
    o_ids = order[:VS_TOP].cpu().numpy()
    o_scores = all_scores[order[:VS_TOP]].cpu().numpy()
    if set(o_ids.tolist()) != set(ids.tolist()):
        raise AssertionError(f"VS top-{VS_TOP} ids differ from the oracle's")
    err = float(np.abs(np.sort(o_scores) - np.sort(scores)).max())
    if not err <= 1e-5:
        raise AssertionError(f"VS scores differ from the oracle's by {err}")
    phase("VS check", t0,
          f"records == plain top-k of mapped scores; ids == oracle's as a "
          f"set; max_abs_score_err={err}; best={float(scores[0])} "
          f"(molecule {int(ids[0])})")
    return rec


# ---------------------------------------------------------------------------
# slice 3c: the paper's SNP-calling pipeline
# ---------------------------------------------------------------------------

SNP_READS = 2_097_152            # 8 shards of 262,144 reads
SNP_ROUNDS, SNP_SEED = 4, 3
N_CHROMOSOMES = 24
# bwa's score on the card against numpy's: float32 products, sin and sums
# in two libraries' orders, on |score| < 20 (the card read 1.43e-6 in
# earlier runs; a shard computed in a coarser type reads 1e-4 or more)
SNP_SCORE_TOL = 1e-5
# a read whose feature sum lies this close to an integer may change
# chromosome if the sum is taken in another order
SNP_BOUNDARY = 1e-5


def feature_sum(reads):
    """The float32 sum of a read's 16 features taken left to right,
    ``((x0 + x1) + x2) + ... + x15``: the order XLA's CPU reduction takes
    ``jnp.sum(reads, axis=-1)`` in, so the chromosomes match the
    reference's bit for bit."""
    s = reads[:, 0].float()
    for j in range(1, reads.shape[1]):
        s = s + reads[:, j].float()
    return s


def bwa_align(reads, rounds: int = SNP_ROUNDS):
    """The surrogate aligner of ``benchmarks/apps.py``: (chromosome, score)
    of each read.  x = sin(x @ mix_{17+r}) + 0.2 x for ``rounds`` rounds,
    score = the sum of x; chromosome = |int32(feature sum)| % 24 (the cast
    truncates toward zero)."""
    import torch
    x = reads.float()
    for r in range(rounds):
        x = torch.sin(x @ fred_mix(17 + r).to(x.device)) + 0.2 * x
    chrom = torch.abs(feature_sum(reads).to(torch.int32)) % N_CHROMOSOMES
    return chrom, torch.sum(x, dim=-1)


def snp_chromosome(recs):
    """``repartition_by``'s key: the chromosome.  A module-level function,
    so that the plan cache and lineage signatures key on one callable."""
    return recs[0]


def register_snp_images() -> None:
    """The ``tools/bwa`` and ``tools/gatk`` images of
    ``benchmarks/apps.py`` in the port's registry: (read features, read
    id) -> (chromosome, score, read id) -> the variants, compacted to the
    front in their order."""
    from repro_torch.core.container import (DEFAULT_REGISTRY, container_op,
                                            make_partition)
    from repro_torch.core.tensors import stable_argsort_false_first
    if "tools/bwa:latest" in DEFAULT_REGISTRY.images():
        return

    @container_op("tools/bwa", registry=DEFAULT_REGISTRY)
    def bwa(part, command: str = "", rounds: int = SNP_ROUNDS, **kw):
        reads, read_id = part.records
        chrom, score = bwa_align(reads, rounds)
        return make_partition((chrom, score, read_id), part.count)

    @container_op("tools/gatk", registry=DEFAULT_REGISTRY)
    def gatk(part, command: str = "", **kw):
        chrom, score, read_id = part.records
        is_var = (score > 0.0) & part.mask()
        order = stable_argsort_false_first(is_var)
        return make_partition(tuple(a[order] for a in (chrom, score,
                                                       read_id)),
                              is_var.sum())


def snp_calling(reads, num_shards: int = 1, device=None,
                rounds: int = SNP_ROUNDS):
    """Paper Listing 3 on the port: map(tools/bwa) -> repartition_by(the
    chromosome) -> map(tools/gatk) -> reduce(toolbox/concat); ``reads``
    is the library or a dataset.  Returns the lazy chain; ``collect(
    shard=0)`` gives the (chromosome, score, read id) variant arrays."""
    from repro_torch.core import MaRe, TextFile
    register_snp_images()
    return (MaRe(reads, num_shards=num_shards, device=device)
            .map(input_mount=TextFile("/in.fastq"),
                 output_mount=TextFile("/out.sam"),
                 image="tools/bwa", rounds=rounds)
            .repartition_by(snp_chromosome)
            .map(image="tools/gatk")
            .reduce(image="toolbox/concat", depth=2))


def snp_oracle(feats: np.ndarray, rounds: int = SNP_ROUNDS) -> tuple:
    """The same formulas in numpy float32 over the whole library:
    (chromosome, score, distance of the feature sum to its nearest
    integer)."""
    x = feats.astype(np.float32)
    for r in range(rounds):
        x = np.sin(x @ fred_mix(17 + r).numpy()) + np.float32(0.2) * x
    s = feats[:, 0].copy()
    for j in range(1, feats.shape[1]):
        s += feats[:, j]
    chrom = np.abs(s.astype(np.int32)) % N_CHROMOSOMES
    return chrom, x.sum(axis=-1), np.abs(s - np.round(s))


def snp_slice(dev, n_reads: int = SNP_READS) -> None:
    """The SNP-calling pipeline over ``n_reads`` reads in 8 shards on
    ``dev``, held to a numpy oracle and to its own exchange."""
    import torch
    from repro_torch.core import MaRe

    t0 = time.perf_counter()
    library = make_library(n_reads, SNP_SEED)
    ds = MaRe(library, num_shards=NUM_SHARDS, device=dev).dataset
    phase("SNP reads", t0, f"reads={n_reads} shards={ds.num_shards} "
          f"cap={ds.capacity} features={FEATURES} seed={SNP_SEED} bytes="
          f"{library[0].nbytes + library[1].nbytes}")

    # the main path, every launch counter read around it: one exchange
    # (keys hashed on the card), no other kernel
    t0 = time.perf_counter()
    reset_launches()
    chain = snp_calling(ds)
    chrom, score, read_id = chain.collect(shard=0)
    launches = read_launches("snp calling", {},
                             exchanges={"hash": 1, "dests": 0})
    report = chain.report()
    print(chain.describe(), flush=True)
    phase("SNP map(tools/bwa) -> repartition_by -> map(tools/gatk) -> "
          "reduce(toolbox/concat)", t0,
          f"variants={len(read_id)} action_wall_s={report.wall_s:.6f} "
          f"diagnostics={json.dumps(report.diagnostics)} "
          f"launches={json.dumps(launches)} "
          f"phases={json.dumps(report.phases)}")
    dropped = {k: v for k, v in report.diagnostics.items()
               if k.endswith("shuffle_dropped")}
    if list(dropped.values()) != [0]:
        raise AssertionError(f"SNP exchange drop counters {dropped}")
    t0 = time.perf_counter()
    warm = []
    for _ in range(3):
        again = snp_calling(ds)
        out = again.collect(shard=0)
        warm.append(again.report().wall_s)
        if not all(np.array_equal(a, b)
                   for a, b in zip(out, (chrom, score, read_id))):
            raise AssertionError("a warm SNP action gave other records")
    phase("SNP warm actions", t0, f"action_wall_s={warm}")

    # the exchange on its own: every read once, each chromosome on one
    # shard; the pipeline's records == gatk + concat over its shards
    t0 = time.perf_counter()
    register_snp_images()
    ex = MaRe(ds).map(image="tools/bwa").repartition_by(
        snp_chromosome).dataset
    cap, counts = ex.capacity, ex.counts.tolist()
    e_chrom, e_score, e_id = (leaf.reshape(NUM_SHARDS, cap)
                              for leaf in ex.records)
    want, seen, owner = [], [], {}
    for s, c in enumerate(counts):
        rows = [t[s, :c] for t in (e_chrom, e_score, e_id)]
        seen.append(rows[2])
        for ch in torch.unique(rows[0]).tolist():
            if owner.setdefault(ch, s) != s:
                raise AssertionError(f"chromosome {ch} on shards "
                                     f"{owner[ch]} and {s}")
        keep = rows[1] > 0
        want.append([r[keep] for r in rows])
    ids_all = torch.sort(torch.cat(seen)).values
    if not torch.equal(ids_all, torch.arange(n_reads, device=dev,
                                             dtype=ids_all.dtype)):
        raise AssertionError("the exchange lost or repeated reads")
    for i, got in enumerate((chrom, score, read_id)):
        exp = torch.cat([w[i] for w in want]).cpu().numpy()
        if not np.array_equal(got, exp):
            raise AssertionError("SNP records != gatk + concat over the "
                                 "exchange's shards")
    by_chrom = np.bincount(e_chrom.reshape(-1)[
        (torch.arange(cap, device=dev)[None, :]
         < torch.tensor(counts, device=dev)[:, None]).reshape(-1)
    ].cpu().numpy(), minlength=N_CHROMOSOMES)
    phase("SNP exchange", t0,
          f"per-shard valid counts={counts} (skew: max/mean="
          f"{max(counts) / (n_reads / NUM_SHARDS):.3f}) out_cap={cap} "
          f"chromosome->shard={json.dumps(dict(sorted(owner.items())))} "
          f"reads by chromosome={by_chrom.tolist()}; records == gatk + "
          f"concat over the shards")

    # the numpy oracle over the whole library
    t0 = time.perf_counter()
    o_chrom, o_score, frac = snp_oracle(library[0])
    near = frac < SNP_BOUNDARY
    chrom_diff = o_chrom[read_id] != chrom
    if (chrom_diff & ~near[read_id]).any():
        raise AssertionError(f"SNP chromosomes differ from the oracle's on "
                             f"{int(chrom_diff.sum())} reads away from an "
                             f"integer boundary")
    score_err = float(np.abs(o_score[read_id] - score).max())
    if not score_err <= SNP_SCORE_TOL:
        raise AssertionError(f"SNP scores differ from the oracle's by "
                             f"{score_err}")
    borderline = np.abs(o_score) <= SNP_SCORE_TOL
    o_var = np.flatnonzero(o_score > 0)
    diff = np.setxor1d(o_var, read_id)
    if len(np.unique(read_id)) != len(read_id) or \
            not borderline[diff].all():
        raise AssertionError(f"SNP variants differ from the oracle's on "
                             f"{diff.size} reads, not all borderline")
    for ch in range(N_CHROMOSOMES):
        ids_c = read_id[chrom == ch]
        if (np.diff(ids_c) <= 0).any():
            raise AssertionError(f"chromosome {ch}'s variants out of read "
                                 f"order")
    phase("SNP check", t0,
          f"variants={len(read_id)} oracle_variants={len(o_var)} "
          f"differing={diff.size} (borderline reads |score|<="
          f"{SNP_SCORE_TOL}: {int(borderline.sum())}); chromosome "
          f"differences={int(chrom_diff.sum())} (reads within "
          f"{SNP_BOUNDARY} of an integer boundary: {int(near.sum())}); "
          f"max_abs_score_err={score_err}; each chromosome's variants in "
          f"read order")


# ---------------------------------------------------------------------------
# slice 4: hymba-1.5b (hybrid attention + SSM) serving at full width
# ---------------------------------------------------------------------------

HYBRID_ARCH = "hymba-1.5b"
HYMBA_PARAMS = 1_342_006_400     # the reference's init_lm leaves, counted
SSM_REPLACES = "src/repro/kernels/ssm_scan/kernel.py:72"
SSM_SOURCE = "src/repro_torch/csrc/ssm_scan.cu"
# kernel vs plain version: both accumulate in f32, in another order (the
# projection's sum over d, the sum over n); hold y and h within 1e-3 of
# their largest magnitude
SSM_TOL_FRAC = 1e-3


def ssm_bound(b: int, t: int, d: int, n: int, itemsize: int):
    """(bound ms, by) of the scan on these inputs
    (``repro_torch.kernels.work.ssm``: its inputs read and outputs written
    once over HBM bandwidth, against the projection's multiply-adds and 5
    operations a channel-step and 7 a state-step at the CUDA cores' f32
    peak)."""
    from repro_torch.kernels import work
    return work.ssm(b, t, d, n, itemsize).bound()

# The chunked route's time is bounded by its transcendentals, not by the
# bound above: one exp a state and step, an exp and a log1p (softplus) a
# channel and step, on the MUFU units at 16 results a clock an SM (4 a
# clock on each of an SM's 4 sub-partitions), at the H100 SXM's 1.98 GHz
# boost clock (data sheet)
MUFU_PER_S = 16 * 132 * 1.98e9


def ssm_mufu_floor_ms(b: int, t: int, d: int, n: int, chunk: int) -> tuple:
    """(the floor of one pass over the steps, the floor of the chunked
    route at ``chunk``: the chunk-end pass runs every chunk but the last,
    the re-run all of them, and the carries add an exp a state and chunk
    end)."""
    per_step = b * d * (n + 2)
    nc = -(-t // chunk)
    one = per_step * t
    chunked = one + per_step * (nc - 1) * chunk + b * d * n * (nc - 1)
    return one / MUFU_PER_S * 1e3, chunked / MUFU_PER_S * 1e3


def ssm_inputs(dev, g, b, t, d, n, dtype, carried: bool,
               h0_scale: float = 0.3, dt_shift: float = 0.0,
               a_shift: float = 0.0):
    """Inputs shaped like the model's: xc a SiLU output, x_proj at the
    init's 1/sqrt(d) scale, dt_bias and a_log near the init's, h0 zero
    (a prefill) or carried (a decode step, ``h0_scale`` x a normal).
    ``dt_shift`` moves dt_bias: a shift of -6 makes dt ~2.5e-3, so that
    the state decays over thousands of steps, not a few.  ``a_shift``
    moves a_log: +6 with dt ~3 makes A dt ~1e3, and a = exp(-A dt)
    underflows to 0."""
    import torch

    def rn(*shape):
        return torch.randn(shape, device=dev, generator=g)

    xc = torch.nn.functional.silu(rn(b, t, d)).to(dtype)
    x_proj = (rn(d, 2 * n + 1) / d ** 0.5).to(dtype)
    dt_bias = 0.5 * rn(d) + dt_shift
    a_log = torch.log(torch.arange(1, n + 1, device=dev,
                                   dtype=torch.float32)).repeat(d, 1) \
        + 0.1 * rn(d, n) + a_shift
    h0 = h0_scale * rn(b, d, n) if carried else torch.zeros((b, d, n),
                                                            device=dev)
    return xc, x_proj, dt_bias, a_log, h0


def ssm_serial(xc, x_proj, dt_bias, a_log, h0):
    """The serial kernel (one thread a state walking all of T; the route
    of every call before the chunked and step routes) through its C
    entry, with its split projection as it was launched: timed beside the
    routes in turns, never a route of the port's wrapper."""
    import torch
    from repro_torch.kernels.build import check_launch
    from repro_torch.kernels.ssm_scan import kernel as smod
    b, t, d = xc.shape
    n = a_log.shape[1]
    lib = smod.LIBRARY.load()
    # the C launcher picks the projection's d-split; the scratch holds it
    splits = lib.ssm_scan_serial_splits(b, t, d)
    proj = torch.empty((splits, b * t, 2 * n + 1), dtype=torch.float32,
                       device=xc.device)
    y = torch.empty((b, t, d), dtype=torch.float32, device=xc.device)
    h = torch.empty((b, d, n), dtype=torch.float32, device=xc.device)
    entry = ("ssm_scan_serial_bf16" if xc.dtype == torch.bfloat16
             else "ssm_scan_serial_f32")
    err = getattr(lib, entry)(
        xc.data_ptr(), x_proj.data_ptr(), dt_bias.data_ptr(),
        a_log.data_ptr(), h0.data_ptr(), proj.data_ptr(), y.data_ptr(),
        h.data_ptr(), b, t, d, n, torch.cuda.current_stream().cuda_stream)
    check_launch("ssm_scan (serial)", err)
    return y, h


def ssm_compare(name, got, want, y_tol: float = SSM_TOL_FRAC) -> tuple:
    """(max abs error, its fraction of the largest |value|) over y and h;
    raises past ``y_tol`` (y's) or SSM_TOL_FRAC (h's)."""
    err = frac = 0.0
    for what, a, b, tol in zip(("y", "h"), got, want,
                               (y_tol, SSM_TOL_FRAC)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"ssm {name} {what}: {a.dtype}"
                                 f"{tuple(a.shape)} vs {b.dtype}"
                                 f"{tuple(b.shape)}")
        e = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        if not e <= tol * scale:
            raise AssertionError(f"ssm {name} {what}: max abs err {e} > "
                                 f"{tol} x {scale}")
        err, frac = max(err, e), max(frac, e / max(scale, 1e-30))
    return err, frac


def ssm_checked(name, args, **kw) -> tuple:
    """One kernel call held to the plain version; raises unless it was
    one launch on the route :func:`route` names for it.  Returns
    (route, outputs, max abs error, its fraction of the largest
    |value|)."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel as smod
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    xc = args[0]
    want_route = smod.route(xc.shape[1], xc.dtype, xc.device)
    before = dict(smod.LAUNCHES_BY_ROUTE)
    total = smod.LAUNCHES
    got = smod.ssm_scan_kernel(*args, **kw)
    torch.cuda.synchronize()
    moved = {r: smod.LAUNCHES_BY_ROUTE[r] - before[r] for r in before}
    if smod.LAUNCHES - total != 1 or moved != {
            r: int(r == want_route) for r in moved}:
        raise AssertionError(f"ssm {name}: launches by route {moved}, "
                             f"expected one on {want_route}")
    err, frac = ssm_compare(name, got, ssm_scan_ref(*args))
    return want_route, got, err, frac


def ssm_kernel_phase(dev, d: int, n: int) -> dict:
    """SSM kernel vs its plain version at hymba's prefill and decode
    shapes, at the chunk's edges and on edge cases, each on the route it
    should take; times the chunked route against the serial kernel in
    turns, the step route by graph replay and back
    to back, and the plain version."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel as smod
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    bf16, f32 = torch.bfloat16, torch.float32
    L = smod.CHUNK
    cases = [
        # name, b, t, d, n, xc dtype, carried h0
        ("prefill", BATCH, PROMPT, d, n, bf16, False),
        ("decode", BATCH, 1, d, n, bf16, True),
        ("prefill f32", BATCH, PROMPT, d, n, f32, False),
        ("decode f32", BATCH, 1, d, n, f32, True),
        ("odd T=33", 2, 33, d, n, bf16, True),
        ("T=100", 1, 100, d, n, f32, True),
        (f"T=L-1={L - 1}", 2, L - 1, d, n, bf16, True),
        (f"T=L={L}", 2, L, d, n, bf16, True),
        (f"T=L+1={L + 1}", 2, L + 1, d, n, f32, True),
        (f"T={PROMPT}+17", BATCH, PROMPT + 17, d, n, bf16, True),
        ("d=1001 (not a multiple of the block)", 3, 50, 1001, n, bf16, True),
        ("d=1001 decode", 3, 1, 1001, n, bf16, True),
        ("n=2", 2, 40, 37, 2, f32, True),
        ("n=4", 2, 40, 37, 4, bf16, True),
        ("n=8", 2, 40, 37, 8, f32, True),
        ("n=5 (not a power of two)", 1, 17, 9, 5, f32, True),
        ("n=5 decode", 2, 1, 9, 5, bf16, True),
    ]
    g = torch.Generator(device=dev).manual_seed(51)
    errs, fracs, keep = {}, {}, {}
    for name, b, t, dd, nn, dt, carried in cases:
        t0 = time.perf_counter()
        args = ssm_inputs(dev, g, b, t, dd, nn, dt, carried)
        kind, _, errs[name], fracs[name] = ssm_checked(name, args)
        phase(f"ssm check {name}", t0,
              f"xc={tuple(args[0].shape)} {dt} n={nn} carried_h0={carried}"
              f" route={kind} max_abs_err={errs[name]} frac_of_max="
              f"{fracs[name]:.3e} tol_frac={SSM_TOL_FRAC}")
        if name in ("prefill", "decode"):
            keep[name] = args
    # a long carried case: dt ~2.5e-3, so a large h0 reaches every chunk
    # through the carries; its weight in y past the first chunk shows the
    # carry path is taken
    t0 = time.perf_counter()
    name = f"long carried T={PROMPT}, large h0"
    args = ssm_inputs(dev, g, 2, PROMPT, d, n, bf16, True, h0_scale=10.0,
                      dt_shift=-6.0)
    kind, (y, _), errs[name], fracs[name] = ssm_checked(name, args)
    y0, _ = smod.ssm_scan_kernel(*args[:4], torch.zeros_like(args[4]))
    carry = float((y - y0)[:, L:].abs().max())
    if not carry > 100 * errs[name]:
        raise AssertionError(f"ssm {name}: h0 moves y past the first chunk "
                             f"by {carry} only (error {errs[name]})")
    phase(f"ssm check {name}", t0,
          f"route={kind} max_abs_err={errs[name]} frac_of_max="
          f"{fracs[name]:.3e}; h0's part of y past the first chunk: max "
          f"{carry} (last step {float((y - y0)[:, -1].abs().max())})")
    # two halves chained through h == one pass
    t0 = time.perf_counter()
    xc, x_proj, dt_bias, a_log, h0 = ssm_inputs(dev, g, 2, 300, d, n, bf16,
                                                True)
    y, h = smod.ssm_scan_kernel(xc, x_proj, dt_bias, a_log, h0)
    y1, h1 = smod.ssm_scan_kernel(xc[:, :137].contiguous(), x_proj,
                                  dt_bias, a_log, h0)
    y2, h2 = smod.ssm_scan_kernel(xc[:, 137:].contiguous(), x_proj,
                                  dt_bias, a_log, h1)
    errs["chained"], fracs["chained"] = ssm_compare(
        "chained halves", (torch.cat([y1, y2], 1), h2), (y, h))
    phase("ssm check two halves chained == one pass", t0,
          f"T=300 split at 137 max_abs_err={errs['chained']}")
    # the serial kernel, timed below, is held to the plain version too
    t0 = time.perf_counter()
    for what in ("prefill", "decode"):
        name = f"serial kernel {what}"
        errs[name], fracs[name] = ssm_compare(
            name, ssm_serial(*keep[what]), ssm_scan_ref(*keep[what]))
    phase("ssm check serial kernel", t0,
          f"prefill max_abs_err={errs['serial kernel prefill']} decode "
          f"max_abs_err={errs['serial kernel decode']}")

    t0 = time.perf_counter()
    args, dec = keep["prefill"], keep["decode"]
    (ms, serial), t_pre = in_turns(cuda_ms, (
        lambda: smod.ssm_scan_kernel(*args), lambda: ssm_serial(*args)))
    plain = cuda_ms(lambda: ssm_scan_ref(*args), reps=2, warmup=1)
    (ms_dec, serial_dec), t_dec = in_turns(graph_ms, (
        lambda: smod.ssm_scan_kernel(*dec), lambda: ssm_serial(*dec)))
    b2b_dec = cuda_ms(lambda: smod.ssm_scan_kernel(*dec))
    plain_dec = cuda_ms(lambda: ssm_scan_ref(*dec))
    bnd, by = ssm_bound(BATCH, PROMPT, d, n, 2)
    bnd_dec, by_dec = ssm_bound(BATCH, 1, d, n, 2)
    one_pass, floor = ssm_mufu_floor_ms(BATCH, PROMPT, d, n, L)
    floor_dec, _ = ssm_mufu_floor_ms(BATCH, 1, d, n, L)
    phase("ssm timing", t0,
          f"prefill xc={tuple(args[0].shape)} bf16 chunked_ms={ms:.4f} "
          f"(chunk {L}) serial_kernel_ms={serial:.4f}"
          f" in_turns={['%.4f' % v for v in t_pre]} plain_ms={plain:.4f} "
          f"bound_ms={bnd:.4f} ({by}) mufu_floor_ms={floor:.4f} (one pass "
          f"{one_pass:.4f}); decode step graph_ms={ms_dec:.5f} "
          f"serial_graph_ms={serial_dec:.5f} in_turns="
          f"{['%.5f' % v for v in t_dec]} back_to_back_ms={b2b_dec:.5f} "
          f"plain_ms={plain_dec:.4f} bound_ms={bnd_dec:.6f} ({by_dec}) "
          f"mufu_floor_ms={floor_dec:.6f}; library: none")
    return {"name": "ssm_scan", "route": "cuda", "source": SSM_SOURCE,
            "replaces": SSM_REPLACES, "launches": None,
            "max_abs_err": max(errs.values()),
            "max_err_frac_of_max": max(fracs.values()), "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None,
            "library": "none: no single PyTorch call computes a selective "
                       "scan",
            "serial_kernel_ms": serial, "decode_ms": ms_dec,
            "decode_timed": "CUDA graph replay",
            "decode_serial_kernel_ms": serial_dec,
            "decode_back_to_back_ms": b2b_dec, "decode_plain_ms": plain_dec,
            "decode_bound_ms": bnd_dec}


def hybrid_slice(seed: int) -> dict:
    """SSM kernel checks, then hymba serving at full width; returns the
    SSM kernel's JSON record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    cfg = get_config(HYBRID_ARCH)
    L = cfg.num_layers
    windows = [tf.layer_window(cfg, i) for i in range(L)]
    rec = ssm_kernel_phase(dev, cfg.d_model * max(cfg.ssm_expand, 1),
                           cfg.ssm_state)
    # flash at hymba's prefill: GQA group 5, head_dim 64, window 1024 on
    # the sliding-window layers and none on the global ones
    g = torch.Generator(device=dev).manual_seed(52)
    for w in (cfg.window, None):
        flash_check(dev, g, f"hymba window={w}", BATCH, cfg.num_heads,
                    cfg.num_kv_heads, PROMPT, PROMPT, cfg.hd,
                    torch.bfloat16, True, w)
    torch.cuda.empty_cache()

    # the main path: the serving entry, every launch counter read around it
    # the SSM kernel once per layer in the prefill and in each of GEN - 1
    # decode steps; flash once per layer in the prefill
    run, launches = serve_smoke(
        HYBRID_ARCH, seed, {"ssm_scan": L * GEN, "flash_attention": L},
        extra=f"layers={L} windows={windows}",
        ssm_routes={"chunked": L, "step": L * (GEN - 1)})
    params = sum(p.numel() for p in run.params.parameters())
    if params != HYMBA_PARAMS:
        raise AssertionError(f"{params} parameters, expected {HYMBA_PARAMS}")
    check_run(run, cfg)
    sizes = [c.kv.k.shape[2] for c in run.cache]
    want_sizes = [PROMPT + GEN if w is None else w for w in windows]
    if sizes != want_sizes or any(c.kv.pos != PROMPT + GEN - 1
                                  for c in run.cache):
        raise AssertionError(f"cache sizes {sizes} (want {want_sizes}) or "
                             f"positions {[c.kv.pos for c in run.cache]}")
    rec["launches"] = launches["ssm_scan"]
    warm_repeat(run)

    # one prefill and one decode step apart, each with its launches
    t0 = time.perf_counter()
    with torch.no_grad():
        reset_launches()
        logits, cache = run.model.prefill(run.params, run.batch,
                                          PROMPT + 1)
        read_launches(f"{HYBRID_ARCH} prefill", {"ssm_scan": L,
                                                 "flash_attention": L},
                      ssm_routes={"chunked": L})
        reset_launches()
        run.model.decode_step(run.params, cache, torch.from_numpy(
            run.generated[:, 0]).to(dev))
        read_launches(f"{HYBRID_ARCH} decode step", {"ssm_scan": L},
                      ssm_routes={"step": L})
        del cache
    phase("prefill and decode step launches", t0,
          f"prefill ssm_scan={L} (chunked route) flash_attention={L}; "
          f"decode step ssm_scan={L} (step route)")
    # the bf16 checks below are taken against this f32 copy of the weights
    import copy
    from repro_torch.models import build_model
    m32 = build_model(cfg.scaled(dtype="float32"), device=dev)
    p32 = copy.deepcopy(run.params).float()
    compare_scan_routes(run, m32, p32, logits)
    del logits
    teacher_forced_hybrid(run, m32, p32)
    return rec


# The bf16 hybrid stack amplifies rounding: norm_s rescales SSM output
# rows of small RMS, so two roundings of the same computation drift apart
# layer by layer.  At full width and depth the served bf16 model's largest
# logit error against its own weights taken in f32 is 0.35-0.44 of the
# largest |logit|, through either scan route, and its teacher-forced
# decode lies 0.03-0.23 from its own forward pass, depending on the tokens
# (measured on the H100).  So the scan routes, and decode against forward,
# are held to each other on an f32 copy of the served weights, where they
# differ in summation order only (measured 3e-4 and 6e-6 of the largest
# |logit| at 32 layers): within SSM_ROUTE_TOL_FRAC.  In bf16 the kernel
# route (and decode) must lie no farther from that f32 model than the
# chunked route (and the bf16 forward pass) does, plus LOGIT_TOL_FRAC, in
# relative RMS error: over all the logits, not at the largest outlier,
# whose size depends on the tokens.
SSM_ROUTE_TOL_FRAC = 1e-2


def scan_route_prefill(model, params, prompt, impl: str, path: str):
    """One prefill with the SSM scan's route named (the kernel, or the
    reference's chunked scan in its place), launches read around it."""
    import torch
    from repro_torch.models import ssm as ssm_lib
    L = model.cfg.num_layers
    kernel_route = ssm_lib.resolve_scan_impl
    try:
        ssm_lib.resolve_scan_impl = lambda device: impl
        reset_launches()
        with torch.no_grad():
            logits, _ = model.prefill(params, {"tokens": prompt}, PROMPT)
        read_launches(path, {"ssm_scan": L if impl == "kernel" else 0,
                             "flash_attention": L},
                      "simt" if model.cfg.dtype == "float32" else "wgmma",
                      {"chunked": L} if impl == "kernel" else None)
    finally:
        ssm_lib.resolve_scan_impl = kernel_route
    return logits


def rel_rms(a, b) -> float:
    """||a - b|| / ||b|| over all elements, in f32, one batch row at a
    time."""
    num = sum(float(((x.float() - y.float()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.float() ** 2).sum()) for y in b)
    return (num / den) ** 0.5


def hold_to_f32(what: str, f32_diff: float, scale: float, bf16_own: float,
                bf16_ref: float) -> None:
    """Raise unless the f32 pair agrees within SSM_ROUTE_TOL_FRAC of the
    largest |logit| and the bf16 path under test lies within LOGIT_TOL_FRAC
    of the bf16 reference path's relative RMS error (``bf16_own``,
    ``bf16_ref``: each against the f32 model)."""
    if not f32_diff <= SSM_ROUTE_TOL_FRAC * scale:
        raise AssertionError(f"{what}, f32: differ by {f32_diff} (> "
                             f"{SSM_ROUTE_TOL_FRAC} x {scale})")
    if not bf16_own <= bf16_ref + LOGIT_TOL_FRAC:
        raise AssertionError(f"{what}, bf16: relative RMS error {bf16_own} "
                             f"against the f32 model, the reference path's "
                             f"{bf16_ref} (+ {LOGIT_TOL_FRAC} allowed)")


def compare_scan_routes(run, m32, p32, bf16_kernel_logits) -> None:
    """The prefill through the SSM kernel against the same prefill with
    the reference's chunked scan in its place, held to each other on the
    f32 copy and to the f32 model in bf16 (see SSM_ROUTE_TOL_FRAC)."""
    import torch
    t0 = time.perf_counter()
    tokens = run.batch["tokens"]
    bf16_chunked = scan_route_prefill(run.model, run.params, tokens,
                                      "chunked",
                                      f"{HYBRID_ARCH} prefill, chunked scan")
    f32_kernel = scan_route_prefill(m32, p32, tokens, "kernel",
                                    f"{HYBRID_ARCH} prefill f32")
    f32_chunked = scan_route_prefill(m32, p32, tokens, "chunked",
                                     f"{HYBRID_ARCH} prefill f32, chunked "
                                     f"scan")
    scale = max_abs(f32_chunked)
    f32_diff = max_abs_diff(f32_kernel, f32_chunked)
    del f32_kernel
    bf16 = {"kernel": bf16_kernel_logits, "chunked": bf16_chunked}
    rms = {k: rel_rms(v, f32_chunked) for k, v in bf16.items()}
    worst = {k: max_abs_diff(v, f32_chunked) for k, v in bf16.items()}
    bf16_diff = max_abs_diff(bf16_kernel_logits, bf16_chunked)
    del f32_chunked, bf16_chunked, bf16
    torch.cuda.empty_cache()
    hold_to_f32("prefill, SSM kernel vs chunked scan", f32_diff, scale,
                rms["kernel"], rms["chunked"])
    phase("prefill SSM kernel vs chunked scan", t0,
          f"f32: max_abs_diff={f32_diff} max_abs_logit={scale} "
          f"frac={f32_diff / scale:.3e} tol_frac={SSM_ROUTE_TOL_FRAC}; "
          f"bf16 to f32 rel_rms: kernel={rms['kernel']:.5f} chunked="
          f"{rms['chunked']:.5f} (tol +{LOGIT_TOL_FRAC}); bf16 to f32 "
          f"max_abs: kernel={worst['kernel']} chunked={worst['chunked']}; "
          f"bf16 kernel vs chunked max_abs={bf16_diff}")


def teacher_forced_hybrid(run, m32, p32) -> None:
    """Teacher-forced decode (SSM kernel at T = 1 from the carried state,
    ring caches) against the forward pass on the same tokens: on the f32
    copy within SSM_ROUTE_TOL_FRAC, and in bf16 no farther from the f32
    forward pass than the bf16 forward pass is, plus LOGIT_TOL_FRAC."""
    import torch
    t0 = time.perf_counter()
    forced = torch.from_numpy(run.generated[:, :TEACHER_FORCED]).to(
        run.batch["tokens"].device)
    toks = torch.cat([run.batch["tokens"], forced], dim=1)

    def decode_logits(model, params):
        """[prefill's last logits, the decode steps' logits]."""
        out = []
        lg, cache = model.prefill(params, {"tokens": toks[:, :PROMPT]},
                                  PROMPT + TEACHER_FORCED)
        out.append(lg[:, -1])
        del lg
        for t in range(TEACHER_FORCED):
            lg, cache = model.decode_step(params, cache, toks[:, PROMPT + t])
            out.append(lg)
        return torch.stack(out, dim=1)          # [B, 1 + steps, V]

    with torch.no_grad():
        full32 = m32.forward(p32, {"tokens": toks})[:, PROMPT - 1:]
        dec32 = decode_logits(m32, p32)
        full16 = run.model.forward(run.params, {"tokens": toks})[
            :, PROMPT - 1:]
        dec16 = decode_logits(run.model, run.params)
    scale = max_abs(full32)
    f32_diff = max_abs_diff(dec32, full32)
    rms = {"decode": rel_rms(dec16, full32),
           "forward": rel_rms(full16, full32)}
    bf16_diff = max_abs_diff(dec16, full16)
    del full32, dec32, full16, dec16
    hold_to_f32("teacher-forced decode vs forward", f32_diff, scale,
                rms["decode"], rms["forward"])
    phase("teacher-forced decode vs forward", t0,
          f"steps={TEACHER_FORCED} f32: max_abs_diff={f32_diff} "
          f"max_abs_logit={scale} frac={f32_diff / scale:.3e}; bf16 to f32 "
          f"rel_rms: decode={rms['decode']:.5f} forward="
          f"{rms['forward']:.5f} (tol +{LOGIT_TOL_FRAC}); bf16 decode vs "
          f"forward max_abs={bf16_diff} (frac {bf16_diff / scale:.4f})")


# ---------------------------------------------------------------------------
# slice 4b: the SSM scan's dt route, then one AI21-Jamba2-Mini pipeline
# stage (one period: 8 layers) serving at full width
# ---------------------------------------------------------------------------

JAMBA_ARCH = "jamba2-mini"
JAMBA_STAGE_LAYERS = 8           # one period: the benchmark's stage
JAMBA_STAGE_PARAMS = 13_295_237_088
JAMBA_PROMPT, JAMBA_GEN = 65536, 16      # the benchmark cell's request
SSM_DT_REPLACES = ("none: the reference has no Jamba (a second route of "
                   "src/repro/kernels/ssm_scan/kernel.py:72's kernel)")
# the plain version of the dt route over the prefill's 65,536 steps in
# blocks of this many, each from the last one's h (its coefficients for
# all the steps at once would take 68 GB)
SSM_DT_PLAIN_BLOCK = 4096
# the planted fault: the plain version with the chunks' carries dropped
# (each chunk of the kernel's CHUNK steps from a zero state), over this
# many of the prefill's first steps; the out's limit has to reject it
SSM_DT_FAULT_STEPS = 4096
# the gated out in bfloat16 against the plain version in the same
# roundings: y + d_skip u and the product are each rounded once, so a y
# within SSM_TOL_FRAC can land one bfloat16 ulp away (2^-7 of the
# largest |out| at most) at each
SSM_GATE_TOL_BF16 = SSM_TOL_FRAC + 2 * 2 ** -7


def ssm_gate_tol(dtype) -> float:
    import torch
    return SSM_GATE_TOL_BF16 if dtype == torch.bfloat16 else SSM_TOL_FRAC


def ssm_dt_inputs(dev, g, b, t, d, n, dtype, carried: bool):
    """Inputs shaped like Jamba's mixer's: u a SiLU output; dt the
    low-rank projection of a normed row (~N(0, 1), before ``dt_bias`` and
    softplus); B and C RMS-normed rows (~N(0, 1)); ``dt_bias`` Mamba's
    inverse softplus of a dt drawn log-uniform in [0.001, 0.1], so that a
    state decays over tens to thousands of steps and reaches the next
    chunks through the carries; a_log log(1..n); h0 zero (a prefill) or
    carried (a decode step); the gate z (~N(0, 1)) the second half of a
    [b, t, 2d] tensor, read in place as the mixer's; d_skip ones (Mamba's
    initialisation) plus N(0, 0.5^2)."""
    import math

    import torch

    def rn(*shape):
        return torch.randn(shape, device=dev, generator=g)

    step = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand(
        (d,), device=dev, generator=g))
    dt_bias = step + torch.log(-torch.expm1(-step))
    a_log = torch.log(torch.arange(1, n + 1, device=dev,
                                   dtype=torch.float32)).repeat(d, 1)
    h0 = 0.5 * rn(b, d, n) if carried else torch.zeros((b, d, n),
                                                       device=dev)
    return (torch.nn.functional.silu(rn(b, t, d)).to(dtype),
            rn(b, t, d).to(dtype), dt_bias, rn(b, t, n).to(dtype),
            rn(b, t, n).to(dtype), a_log, h0,
            rn(b, t, 2 * d).to(dtype)[..., d:], 1.0 + 0.5 * rn(d))


def ssm_dt_plain(u, dt, dt_bias, bm, cm, a_log, h0, z, d_skip) -> tuple:
    """The dt route's plain version (``ref.ssm_scan_dt_ref``, the gate
    included) over blocks of SSM_DT_PLAIN_BLOCK steps, each from the last
    one's final state: the same recurrence, one step after another."""
    import torch
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_dt_ref
    ys, h = [], h0
    for t0 in range(0, u.shape[1], SSM_DT_PLAIN_BLOCK):
        sl = slice(t0, t0 + SSM_DT_PLAIN_BLOCK)
        y, h = ssm_scan_dt_ref(u[:, sl], dt[:, sl], dt_bias, bm[:, sl],
                               cm[:, sl], a_log, h, z[:, sl], d_skip)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def ssm_dt_checked(name, args) -> tuple:
    """One dt-route call held to the plain version; raises unless it was
    one launch on the route :func:`route` names for it, and none of the
    fused route.  Returns (route, outputs, max abs error, its fraction of
    the largest |value|, the plain version's wall ms)."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel as smod
    u = args[0]
    want_route = smod.route(u.shape[1], u.dtype, u.device)
    before = dict(smod.DT_LAUNCHES_BY_ROUTE)
    total, fused = smod.DT_LAUNCHES, smod.LAUNCHES
    got = smod.ssm_scan_dt_kernel(*args)
    torch.cuda.synchronize()
    moved = {r: smod.DT_LAUNCHES_BY_ROUTE[r] - before[r] for r in before}
    if smod.DT_LAUNCHES - total != 1 or smod.LAUNCHES != fused or \
            moved != {r: int(r == want_route) for r in moved}:
        raise AssertionError(f"ssm dt {name}: launches by route {moved}, "
                             f"fused {smod.LAUNCHES - fused}, expected one "
                             f"on {want_route}")
    t0 = time.perf_counter()
    want = ssm_dt_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, frac = ssm_compare(f"dt {name}", got, want, ssm_gate_tol(u.dtype))
    return want_route, got, err, frac, plain_ms


def ssm_dt_kernel_phase(dev, d: int, n: int) -> dict:
    """The dt route with the mixer's gate vs its plain version at Jamba's
    prefill (1 x 65,536 x d, bf16) and decode-step shapes, at the chunk's
    edges and off the state sizes, each on the route it should take, the
    gated out within :func:`ssm_gate_tol` of its largest |value| and h
    within SSM_TOL_FRAC; a planted fault (the carries between chunks
    dropped) that the out's limit rejects; then both routes timed by graph
    replay and back to back beside their bound, the MUFU floor and the
    plain version."""
    import torch
    from repro_torch.kernels import work
    from repro_torch.kernels.ssm_scan import kernel as smod
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_dt_ref
    bf16, f32 = torch.bfloat16, torch.float32
    L = smod.CHUNK
    cases = [
        # name, b, t, d, n, dtype, carried h0
        ("prefill", 1, JAMBA_PROMPT, d, n, bf16, False),
        ("decode", 1, 1, d, n, bf16, True),
        ("T=1000 carried", 1, 1000, d, n, bf16, True),
        (f"T=L={L}", 2, L, 300, n, f32, True),
        (f"T=L+1={L + 1}", 2, L + 1, 300, n, f32, True),
        ("n=5 d=1000 (not a multiple of the block)", 3, 300, 1000, 5, f32,
         True),
        ("n=5 decode", 3, 1, 1000, 5, f32, True),
        ("n=32", 1, 260, 256, 32, bf16, True),
        ("n=32 decode", 2, 1, 256, 32, bf16, True),
        ("T=2", 1, 2, 64, 4, f32, True),
    ]
    g = torch.Generator(device=dev).manual_seed(53)
    errs, fracs, keep, plain = {}, {}, {}, {}
    for name, b, t, dd, nn, dt, carried in cases:
        t0 = time.perf_counter()
        args = ssm_dt_inputs(dev, g, b, t, dd, nn, dt, carried)
        kind, got, errs[name], fracs[name], plain[name] = ssm_dt_checked(
            name, args)
        phase(f"ssm dt check {name}", t0,
              f"u={tuple(args[0].shape)} {dt} n={nn} carried_h0={carried}"
              f" route={kind} max_abs_err={errs[name]} frac_of_max="
              f"{fracs[name]:.3e} tol_frac={SSM_TOL_FRAC} plain_ms="
              f"{plain[name]:.1f}")
        if name in ("prefill", "decode"):
            keep[name] = (args, got[0])
        del args, got
    # the planted fault: every chunk from a zero state, the carries
    # dropped, over the prefill's first steps
    t0 = time.perf_counter()
    args, y = keep["prefill"]
    steps = SSM_DT_FAULT_STEPS
    chunks = steps // L

    def by_chunk(v):
        return v[:, :steps].reshape(chunks, L, v.shape[2]).contiguous()

    u, dtv, dt_bias, bm, cm, a_log, h0, z, d_skip = args
    tol = ssm_gate_tol(u.dtype)
    y_fault, _ = ssm_scan_dt_ref(by_chunk(u), by_chunk(dtv), dt_bias,
                                 by_chunk(bm), by_chunk(cm), a_log,
                                 torch.zeros((chunks, d, n), device=dev),
                                 by_chunk(z), d_skip)
    y_fault = y_fault.reshape(1, steps, d).float()
    y_want, _ = ssm_dt_plain(u[:, :steps], dtv[:, :steps], dt_bias,
                             bm[:, :steps], cm[:, :steps], a_log, h0,
                             z[:, :steps], d_skip)
    y_want = y_want.float()
    scale = float(y_want.abs().max())
    fault_frac = float((y_fault - y_want).abs().max()) / scale
    own_frac = float((y[:, :steps].float() - y_want).abs().max()) / scale
    del y_fault, y_want
    if not fault_frac > tol:
        raise AssertionError(f"ssm dt planted fault (carries dropped) reads "
                             f"{fault_frac}, within the out's limit {tol}")
    phase("ssm dt planted fault", t0,
          f"carries dropped over the first {steps} steps: frac_of_max="
          f"{fault_frac:.3e} > tol_frac={tol} (the kernel there: "
          f"{own_frac:.3e})")

    t0 = time.perf_counter()
    dec = keep["decode"][0]
    ms = graph_ms(lambda: smod.ssm_scan_dt_kernel(*args), reps=10)
    b2b = cuda_ms(lambda: smod.ssm_scan_dt_kernel(*args), reps=10)
    ms_dec = graph_ms(lambda: smod.ssm_scan_dt_kernel(*dec))
    b2b_dec = cuda_ms(lambda: smod.ssm_scan_dt_kernel(*dec))
    plain_dec = cuda_ms(lambda: ssm_dt_plain(*dec))
    bnd, by = work.ssm_dt(1, JAMBA_PROMPT, d, n, 2).bound()
    bnd_dec, by_dec = work.ssm_dt(1, 1, d, n, 2).bound()
    one_pass, floor = ssm_mufu_floor_ms(1, JAMBA_PROMPT, d, n, L)
    phase("ssm dt timing", t0,
          f"prefill u={tuple(args[0].shape)} bf16 chunked, gated "
          f"graph_ms={ms:.4f}"
          f" back_to_back_ms={b2b:.4f} plain_ms={plain['prefill']:.1f} "
          f"bound_ms={bnd:.4f} ({by}) mufu_floor_ms={floor:.4f} (one pass "
          f"{one_pass:.4f}); decode step graph_ms={ms_dec:.6f} "
          f"back_to_back_ms={b2b_dec:.5f} plain_ms={plain_dec:.4f} "
          f"bound_ms={bnd_dec:.6f} ({by_dec}); library: none")
    del keep
    return {"name": "ssm_scan_dt", "route": "cuda", "source": SSM_SOURCE,
            "replaces": SSM_DT_REPLACES, "launches": None,
            "max_abs_err": max(errs.values()),
            "max_err_frac_of_max": max(fracs.values()),
            "planted_fault_frac_of_max": fault_frac, "gated": True,
            "ms": ms,
            "timed": "CUDA graph replay", "back_to_back_ms": b2b,
            "plain_ms": plain["prefill"], "bound_ms": bnd, "bound_by": by,
            "mufu_floor_ms": floor, "library_ms": None,
            "library": "none: no single PyTorch call computes a selective "
                       "scan",
            "decode_ms": ms_dec, "decode_timed": "CUDA graph replay",
            "decode_back_to_back_ms": b2b_dec, "decode_plain_ms": plain_dec,
            "decode_bound_ms": bnd_dec}


CONV_SOURCE = "src/repro_torch/csrc/mamba_conv.cu"
CONV_REPLACES = ("none: the reference has no Jamba (the mixer's tensor "
                 "code: a float32 pass a tap, the bias, SiLU and a cast)")


def conv_inputs(dev, g, b, t, d, k, dtype, carried: bool):
    """xi the first half of a [b, t, 2d] in-projection output (read in
    place, as the mixer's), conv_w and conv_b ~N(0, 0.5^2), the window
    carried rows or zeros (a prefill's)."""
    import torch

    def rn(*shape):
        return torch.randn(shape, device=dev, generator=g)
    win = rn(b, k - 1, d) if carried else torch.zeros((b, k - 1, d),
                                                      device=dev)
    return (rn(b, t, 2 * d).to(dtype)[..., :d], (0.5 * rn(k, d)).to(dtype),
            (0.5 * rn(d)).to(dtype), win.to(dtype))


def conv_ulps(got, want) -> float:
    """The largest |got - want| in units of the type's ulp at |want|."""
    import torch
    bits = 7 if want.dtype == torch.bfloat16 else 23
    _, e = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                      e - 1 - bits)
    return float(((got.float() - want.float()).abs() / ulp).max())


def mamba_conv_phase(dev, d: int, k: int) -> dict:
    """The Mamba mixer's conv kernel vs its plain version (the mixer's
    conv as it was) at Jamba's prefill (1 x 65,536 x d, bf16, a zero
    window) and decode-step shapes, odd T with a carried window, a partial
    last step tile, and float32, each one launch on the route the scan's
    :func:`route` names: u within one ulp of its type (the share
    bit-equal printed), the new window bit for bit; then both shapes
    timed by graph replay and back to back beside the bound and the plain
    version."""
    import torch
    from repro_torch.kernels import work
    from repro_torch.kernels.mamba_conv import kernel as cmod
    from repro_torch.kernels.mamba_conv.ref import mamba_conv_ref
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, b, t, d, dtype, carried window
        ("prefill", 1, JAMBA_PROMPT, d, bf16, False),
        ("decode", 1, 1, d, bf16, True),
        ("T=7 carried", 1, 7, d, bf16, True),
        ("T=2 (below K-1)", 2, 2, 256, bf16, True),
        ("b=3 T=130 d=1000 (a partial last tile)", 3, 130, 1000, bf16,
         True),
        ("float32", 2, 300, 1024, f32, True),
    ]
    g = torch.Generator(device=dev).manual_seed(59)
    ulps, equal, keep, plain = {}, {}, {}, {}
    for name, b, t, dd, dt, carried in cases:
        t0 = time.perf_counter()
        args = conv_inputs(dev, g, b, t, dd, k, dt, carried)
        want_route = "step" if t == 1 else "chunked"
        before = dict(cmod.LAUNCHES_BY_ROUTE)
        got = cmod.mamba_conv(*args)
        torch.cuda.synchronize()
        moved = {r: cmod.LAUNCHES_BY_ROUTE[r] - before[r] for r in before}
        if moved != {r: int(r == want_route) for r in moved}:
            raise AssertionError(f"mamba conv {name}: launches by route "
                                 f"{moved}, expected one on {want_route}")
        t1 = time.perf_counter()
        want = mamba_conv_ref(*args)
        torch.cuda.synchronize()
        plain[name] = (time.perf_counter() - t1) * 1e3
        ulps[name] = conv_ulps(got[0], want[0])
        equal[name] = float((got[0] == want[0]).float().mean())
        if not ulps[name] <= 1.0 or not torch.equal(got[1], want[1]):
            raise AssertionError(f"mamba conv {name}: u {ulps[name]} ulps "
                                 f"from plain, window equal "
                                 f"{torch.equal(got[1], want[1])}")
        phase(f"mamba conv check {name}", t0,
              f"xi={tuple(args[0].shape)} row_stride={args[0].stride(1)} "
              f"{dt} carried={carried} route={want_route} max_ulps="
              f"{ulps[name]} bit_equal_share={equal[name]:.6f} window "
              f"bit-equal plain_ms={plain[name]:.1f}")
        if name in ("prefill", "decode"):
            keep[name] = args
        del args, got, want

    t0 = time.perf_counter()
    pre, dec = keep["prefill"], keep["decode"]
    ms = graph_ms(lambda: cmod.mamba_conv(*pre), reps=10)
    b2b = cuda_ms(lambda: cmod.mamba_conv(*pre), reps=10)
    plain_b2b = cuda_ms(lambda: mamba_conv_ref(*pre), reps=5, warmup=1)
    ms_dec = graph_ms(lambda: cmod.mamba_conv(*dec))
    b2b_dec = cuda_ms(lambda: cmod.mamba_conv(*dec))
    plain_dec = cuda_ms(lambda: mamba_conv_ref(*dec))
    bnd, by = work.mamba_conv(1, JAMBA_PROMPT, d, k, 2).bound()
    bnd_dec, by_dec = work.mamba_conv(1, 1, d, k, 2).bound()
    phase("mamba conv timing", t0,
          f"prefill xi={tuple(pre[0].shape)} bf16 graph_ms={ms:.4f} "
          f"back_to_back_ms={b2b:.4f} plain_back_to_back_ms="
          f"{plain_b2b:.4f} bound_ms={bnd:.4f} ({by}); decode step "
          f"graph_ms={ms_dec:.6f} back_to_back_ms={b2b_dec:.5f} "
          f"plain_back_to_back_ms={plain_dec:.4f} bound_ms={bnd_dec:.6f} "
          f"({by_dec}); library: none")
    del keep, pre, dec
    return {"name": "mamba_conv", "route": "cuda", "source": CONV_SOURCE,
            "replaces": CONV_REPLACES, "launches": None,
            "max_ulps": max(ulps.values()),
            "bit_equal_share": min(equal.values()), "ms": ms,
            "timed": "CUDA graph replay", "back_to_back_ms": b2b,
            "plain_ms": plain_b2b, "bound_ms": bnd, "bound_by": by,
            "library_ms": None,
            "library": "none: no single PyTorch call computes a causal "
                       "conv with its bias and SiLU",
            "decode_ms": ms_dec, "decode_timed": "CUDA graph replay",
            "decode_back_to_back_ms": b2b_dec, "decode_plain_ms": plain_dec,
            "decode_bound_ms": bnd_dec}


def jamba_counts(cfg) -> tuple:
    """(attention layers, Mamba layers, MoE layers) of ``cfg``."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    return (sum(m == "attention" for m, _ in kinds),
            sum(m == "mamba" for m, _ in kinds),
            sum(f == "moe" for _, f in kinds))


def jamba_stage(seed: int, cfg=None, batch: int = BATCH,
                prompt: int = PROMPT, gen: int = GEN,
                request: tuple = (JAMBA_PROMPT, JAMBA_GEN),
                device: str = "cuda") -> None:
    """One Jamba pipeline stage (``cfg``: jamba2-mini cut to one period,
    by default) through the serving entry points: a prefill of ``batch``
    x ``prompt`` and ``gen`` - 1 greedy decode steps, every launch counter
    read around each (flash once per attention layer in the prefill, the
    dispatch once per MoE layer in both, the dt route once per Mamba
    layer on ``chunked`` in the prefill and on ``step`` in each decode
    step, and the conv the same, nothing else); the teacher-forced check (the kept logits and
    TEACHER_FORCED decode steps against the forward pass); then the
    benchmark cell's request (``launch.serve.greedy_request``, batch 1,
    ``request`` = (prompt, decode steps)) twice, its launches read, the
    second one's phases printed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    dev = torch.device(device)
    if cfg is None:
        cfg = get_config(JAMBA_ARCH).scaled(num_layers=JAMBA_STAGE_LAYERS)
    attn, mamba, moe = jamba_counts(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    with torch.no_grad():
        params = model.init(seed)
    torch.cuda.synchronize()
    count = sum(p.numel() for p in params.parameters())
    if cfg.d_model == 4096 and count != JAMBA_STAGE_PARAMS:
        raise AssertionError(f"{count} parameters, expected "
                             f"{JAMBA_STAGE_PARAMS}")
    phase("jamba stage weights", t0,
          f"layers={cfg.num_layers} kinds="
          f"{[cfg.layer_kind(i) for i in range(cfg.num_layers)]} "
          f"params={count}")

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), device=dev,
                           generator=g)
    with torch.no_grad():
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens},
                                      prompt + gen)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        read_launches(f"{JAMBA_ARCH} prefill", {
            "flash_attention": attn, "moe_dispatch": moe,
            "ssm_scan_dt": mamba, "mamba_conv": mamba},
            dt_routes={"chunked": mamba}, conv_routes={"chunked": mamba})
        reset_launches()
        tok = torch.argmax(logits[:, -1], dim=-1)
        out = [tok]
        t1 = time.perf_counter()
        for _ in range(gen - 1):
            lg, cache = model.decode_step(params, cache, tok)
            tok = torch.argmax(lg, dim=-1)
            out.append(tok)
        torch.cuda.synchronize()
        decode_s = (time.perf_counter() - t1) / max(gen - 1, 1)
        read_launches(f"{JAMBA_ARCH} decode", {
            "moe_dispatch": moe * (gen - 1),
            "ssm_scan_dt": mamba * (gen - 1),
            "mamba_conv": mamba * (gen - 1)},
            dt_routes={"step": mamba * (gen - 1)},
            conv_routes={"step": mamba * (gen - 1)})
    run = serve.SmokeRun(model=model, params=params,
                         batch={"tokens": tokens}, logits=logits, cache=None,
                         generated=torch.stack(out, 1).cpu().numpy(),
                         prefill_s=prefill_s, decode_s_per_token=decode_s)
    del cache
    phase("jamba stage serve", t0,
          f"batch={batch} prompt={prompt} gen={gen} prefill_ms="
          f"{prefill_s * 1e3:.3f} decode_ms_per_token={decode_s * 1e3:.3f}"
          f" launches: prefill flash_attention={attn} moe_dispatch={moe} "
          f"ssm_scan_dt and mamba_conv chunked={mamba}; decode ssm_scan_dt "
          f"and mamba_conv step={mamba * (gen - 1)} moe_dispatch="
          f"{moe * (gen - 1)}; generated "
          f"{run.generated[:2].tolist()}")
    want = (batch, cfg.logits_to_keep, cfg.vocab_size)
    if logits.shape != want or not bool(torch.isfinite(logits).all()) or \
            not ((run.generated >= 0)
                 & (run.generated < cfg.vocab_size)).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite of shape {want}, or generated ids "
                             f"outside the vocabulary")
    teacher_forced(run, launches={
        "path": f"{JAMBA_ARCH} forward",
        "expect": {"flash_attention": attn, "moe_dispatch": moe,
                   "ssm_scan_dt": mamba, "mamba_conv": mamba},
        "dt_routes": {"chunked": mamba}, "conv_routes": {"chunked": mamba}})
    del run, logits

    req_prompt, req_gen = request
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in range(2):
        t0 = time.perf_counter()
        ids = torch.randint(0, cfg.vocab_size, (1, req_prompt), device=dev,
                            generator=g)
        reset_launches()
        answer = serve.greedy_request(model, params, ids, req_gen)
        read_launches(f"{JAMBA_ARCH} request", {
            "flash_attention": attn, "moe_dispatch": moe * (req_gen + 1),
            "ssm_scan_dt": mamba * (req_gen + 1),
            "mamba_conv": mamba * (req_gen + 1)},
            dt_routes={"chunked": mamba, "step": mamba * req_gen},
            conv_routes={"chunked": mamba, "step": mamba * req_gen})
        if not bool(torch.isfinite(answer.logits).all()) or tuple(
                answer.ids.shape) != (1, req_gen + 1):
            raise AssertionError(f"request: ids {tuple(answer.ids.shape)} "
                                 f"or logits not finite")
        ph = answer.report.phases
        phase(f"jamba request {k}", t0,
              f"prompt={req_prompt} decode_steps={req_gen} wall_ms="
              f"{answer.report.wall_s * 1e3:.1f} prefill_ms="
              f"{ph['prefill'] * 1e3:.1f} decode_ms_per_step="
              f"{ph['decode'] * 1e3 / req_gen:.2f} peak_alloc_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} launches: "
              f"ssm_scan_dt and mamba_conv chunked={mamba} step="
              f"{mamba * req_gen} "
              f"moe_dispatch={moe * (req_gen + 1)} flash_attention={attn}")
        del answer


def jamba_slice(seed: int) -> list:
    """The gated dt route's and the conv kernel's checks and timings, then
    one Jamba stage serving at full width; returns the two kernels' JSON
    records."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(JAMBA_ARCH)
    di = cfg.d_model * cfg.ssm_expand
    dev = torch.device("cuda")
    recs = [ssm_dt_kernel_phase(dev, di, cfg.ssm_state)]
    torch.cuda.empty_cache()
    recs.append(mamba_conv_phase(dev, di, cfg.ssm_conv))
    torch.cuda.empty_cache()
    jamba_stage(seed)
    for rec in recs:
        rec["launches"] = PATH_LAUNCHES[f"{JAMBA_ARCH} request"][rec["name"]]
    return recs


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# slice 7: Llama-3.2-1B training at full width and depth, through the
# flash-attention backward kernel
# ---------------------------------------------------------------------------

FLASH_BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
FLASH_BWD_REPLACES = ("src/repro/kernels/flash_attention/kernel.py:86 "
                      "(its gradient: the port's own kernel, as no "
                      "pl.pallas_call in the reference computes one and "
                      "jax.grad through this one raises; the reference "
                      "trains through XLA's autodiff of "
                      "src/repro/kernels/flash_attention/ref.py:"
                      "attention_ref)")
#: Relative RMS error of dq, dk, dv against the plain backward taken in
#: f32 on the same inputs: f32 kernels differ in summation order only
#: (measured <= 4e-7 on the H100); bf16 outputs carry bf16's rounding
#: (2**-9 relative, ~1.7e-3 RMS measured on the CUDA-core route, which
#: rounds only its outputs; the wgmma route also rounds P and dS to bf16
#: for the tensor cores, ~2.5e-3 measured, beside SDPA's backward's,
#: printed in the same run).
FLASH_BWD_REL_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 5e-3}
#: Largest |lse_kernel - lse_plain| over the rows that see a key, the
#: plain forward's taken in f32 on the same q, k, v.  lse is about 3-9 at
#: these shapes, so f32's rounding is ~1e-6; bf16 inputs are exact in
#: f32, and the wgmma route's exp2 / log2 in the log2 domain add a few
#: f32 ulps.  A fault in the log-domain bookkeeping (a lost ln 2 or scale
#: factor) is off by ~1 or more.
FLASH_LSE_ABS_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 1e-4}
#: The full-width f32 training step's gradients through the kernels
#: against the same step with attn_impl="ref", per leaf:
#: ||g_kernel - g_ref|| / ||g_ref||.  Both are f32 with TF32 off; they
#: differ in the attention's summation order only.
TRAIN_GRAD_REL_TOL = 1e-4
TRAIN_STEPS = 4
TRAIN_SAVE_AT = 2
TRAIN_LR, TRAIN_WARMUP = 3e-4, 1
TRAIN_GRAD_CHECK_LAYERS = 2


def flash_bwd_bound(b, hq, hkv, sq, sk, d, causal, window, itemsize,
                    per_pair: int = 10):
    """(bound ms, by) of attention's gradient
    (``repro_torch.kernels.work.flash_bwd``: five products of 2 d
    operations a kept pair, ``per_pair`` = 10; 14 gives the floor of a
    design that recomputes S and dP in two passes)."""
    from repro_torch.kernels import work
    return work.flash_bwd(b * hq, hq // hkv, sq, sk, d, causal, window,
                          itemsize, per_pair).bound()


def flash_bwd_check(dev, g, name, b, hq, hkv, sq, sk, d, dt, causal,
                    window, sdpa: bool = False, simt: bool = False
                    ) -> tuple:
    """The forward kernel (with its lse) and one backward launch on random
    inputs, on the route :func:`backward.route` names for them (asserted
    from the wrapper's counts). The kernel's lse is held to the plain
    forward's, taken in f32 on the same q, k, v (the same rows +inf, the
    rest within FLASH_LSE_ABS_TOL), and its o by relative RMS error; dq,
    dk, dv are held by relative RMS error to the plain backward taken in
    f32 from the plain forward's o and lse, so no output of the kernels
    feeds the value they are held to; a second launch must give the same
    bytes (no float atomics); rows that see no key must get a zero dq. With
    ``sdpa`` (causal, Sq == Sk) SDPA's autograd backward on the same bf16
    inputs is held to the same f32 value as a yardstick ("sdpa_rel_rms").
    With ``simt`` the CUDA-core kernels (``backward.simt_launch``) are held
    the same way on the same inputs, whatever route the wrapper takes: two
    launches giving the same bytes, within the tolerance ("simt_rel_rms",
    "simt_max_abs_err").
    Returns (the relative RMS errors, the largest absolute error under
    "max_abs_err", lse's under "lse_abs_err" and the route under "route";
    the kernels' inputs)."""
    import torch
    from repro_torch.kernels.flash_attention import backward as bmod
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_plain)
    t0 = time.perf_counter()
    group = hq // hkv
    q = torch.randn((b * hq, sq, d), device=dev, generator=g).to(dt)
    k = torch.randn((b * hkv, sk, d), device=dev, generator=g).to(dt)
    v = torch.randn((b * hkv, sk, d), device=dev, generator=g).to(dt)
    do = torch.randn((b * hq, sq, d), device=dev, generator=g).to(dt)
    o, lse = fmod.flash_attention_kernel(q, k, v, group=group,
                                         causal=causal, window=window,
                                         return_lse=True)
    o_ref, lse_ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                           group, causal=causal,
                                           window=window, return_lse=True)
    none = torch.isinf(lse_ref)
    if lse.shape != lse_ref.shape or not torch.equal(torch.isinf(lse),
                                                     none) or \
            not bool((lse[none] > 0).all()):
        raise AssertionError(f"flash backward {name}: the forward's lse "
                             f"is +inf on other rows than the plain's")
    lse_err = float((lse[~none] - lse_ref[~none]).abs().max()) \
        if bool((~none).any()) else 0.0
    o_err = rel_rms(o, o_ref)
    lse_tol = FLASH_LSE_ABS_TOL[str(dt)]
    if not (lse_err <= lse_tol and o_err <= FLASH_REL_RMS_TOL):
        raise AssertionError(f"flash backward {name}: the forward's lse "
                             f"{lse_err} > {lse_tol} or o {o_err} > "
                             f"{FLASH_REL_RMS_TOL} from the plain forward")
    before = dict(bmod.LAUNCHES_BY_ROUTE)
    kind = bmod.route(dt, d, dev)
    got = bmod.flash_attention_bwd_kernel(q, k, v, o, do, lse, group=group,
                                          causal=causal, window=window)
    again = bmod.flash_attention_bwd_kernel(q, k, v, o, do, lse,
                                            group=group, causal=causal,
                                            window=window)
    torch.cuda.synchronize()
    launched = {r: n - before[r] for r, n in bmod.LAUNCHES_BY_ROUTE.items()}
    if launched != {r: 2 * (r == kind) for r in launched}:
        raise AssertionError(f"flash backward {name}: launches by route "
                             f"{launched}, expected 2 on {kind}")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"flash backward {name}: two launches differ")
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     o_ref, do.float(), lse_ref, group,
                                     causal=causal, window=window)
    del o_ref, lse_ref
    tol = FLASH_BWD_REL_TOL[str(dt)]
    errs, abs_err, lib = {}, 0.0, {}
    if sdpa:
        q4, k4, v4, do4 = (t.reshape(b, -1, t.shape[1], d)
                           for t in (q, k, v, do))
        lib_grads = sdpa_backward_call(q4, k4, v4, do4)()
        lib = {w: rel_rms(x.reshape(y.shape), y)
               for w, x, y in zip(("dq", "dk", "dv"), lib_grads, want)}
        del q4, k4, v4, do4, lib_grads
    for what, x, y in zip(("dq", "dk", "dv"), got, want):
        if x.dtype != dt or x.shape != y.shape:
            raise AssertionError(f"flash backward {name}: {what} "
                                 f"{x.dtype} {tuple(x.shape)}")
        errs[what] = rel_rms(x, y)
        abs_err = max(abs_err, float((x.float() - y).abs().max()))
    simt_errs, simt_abs = {}, 0.0
    if simt:
        by_simt = bmod.simt_launch(q, k, v, o, do, lse, group=group,
                                   causal=causal, window=window)
        if not all(torch.equal(x, y) for x, y in zip(
                by_simt, bmod.simt_launch(q, k, v, o, do, lse, group=group,
                                          causal=causal, window=window))):
            raise AssertionError(f"flash backward {name}: two launches of "
                                 f"the simt kernels differ")
        for what, x, y in zip(("dq", "dk", "dv"), by_simt, want):
            simt_errs[what] = rel_rms(x, y)
            simt_abs = max(simt_abs, float((x.float() - y).abs().max()))
        del by_simt
    empty = sq - sk if causal and sq > sk else 0
    if empty and not bool((got[0].reshape(b * hq, sq, d)[:, :empty] == 0
                           ).all()):
        raise AssertionError(f"flash backward {name}: a row without keys "
                             f"has a gradient")
    if not max(errs.values()) <= tol:
        raise AssertionError(f"flash backward {name}: relative RMS errors "
                             f"{errs} > {tol}")
    if simt and not max(simt_errs.values()) <= tol:
        raise AssertionError(f"flash backward {name}: the simt kernels' "
                             f"relative RMS errors {simt_errs} > {tol}")
    del want, again
    phase(f"flash backward check {name}", t0,
          f"q=({b * hq}, {sq}, {d}) kv=({b * hkv}, {sk}, {d}) {dt} "
          f"group={group} causal={causal} window={window} route={kind} "
          f"rel_rms_err={json.dumps(errs)} tol={tol} max_abs_err={abs_err} "
          + (f"sdpa_backward_rel_rms_err={json.dumps(lib)} " if sdpa else "")
          + (f"simt_rel_rms_err={json.dumps(simt_errs)} simt_max_abs_err="
             f"{simt_abs} simt_deterministic=True " if simt else "")
          + f"forward vs plain: lse_abs_err={lse_err} (tol {lse_tol}) "
          f"o_rel_rms_err={o_err:.3e} rows_without_keys={empty * b * hq} "
          f"deterministic=True")
    return ({**errs, "max_abs_err": abs_err, "lse_abs_err": lse_err,
             "route": kind, "sdpa_rel_rms": lib, "simt_rel_rms": simt_errs,
             "simt_max_abs_err": simt_abs}, (q, k, v, o, do, lse))


def sdpa_backward_call(q4, k4, v4, do4):
    """Autograd of SDPA (causal, GQA) on the same inputs: the forward once,
    the backward per call; never called by the port."""
    import torch
    import torch.nn.functional as F
    q4, k4, v4 = (t.detach().requires_grad_() for t in (q4, k4, v4))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                         enable_gqa=True)
    return lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                       retain_graph=True)


def flash_bwd_kernel_phase(dev) -> dict:
    """The backward kernel against its plain version, and the forward's lse
    against the plain forward's (``flash_bwd_check``), each case on the
    route the wrapper takes: in f32 (``simt``) at a small shape for every
    head dim and for causal, windowed and not causal calls, GQA 1 and 4,
    an Sk tail tile and rows without keys; in bf16 (``wgmma`` at head dims
    64 and 128) not causal, windowed, causal GQA 4 at D = 128 with an Sk
    tail, rows without keys, and at the Llama-3.2-1B training shape, where
    SDPA's backward's error is printed beside the kernel's; in bf16 on
    ``simt`` causal GQA 4 at D = 96 with an Sk tail, and the ``simt``
    kernels at the training shape, held like the route taken there. The
    kernel is timed at the training shape by CUDA-graph replay in turns
    with the ``simt`` kernels on the same inputs, and back to back in
    turns with both and
    SDPA's autograd backward, beside the plain version, the bound and the
    two-pass design's floor; and the forward with and without its lse
    output, in turns by graph replay.  Returns the backward's JSON
    record."""
    import torch
    from repro_torch.kernels.flash_attention import backward as bmod
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_plain
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(22)
    cases = [(f"f32 d={d}", 1, 4, 1, 130, 130, d, f32, True, None)
             for d in fmod.HEAD_DIMS]
    cases += [
        # name, b, hq, hkv, sq, sk, d, dtype, causal, window
        ("f32 not causal, Sk tail", 2, 4, 4, 70, 133, 64, f32, False, None),
        ("f32 window 17, GQA 2", 1, 4, 2, 150, 150, 64, f32, True, 17),
        ("f32 GQA 4, Sq < Sk", 2, 8, 2, 40, 150, 64, f32, True, None),
        ("f32 rows without keys", 1, 4, 2, 150, 50, 32, f32, True, None),
        ("bf16 not causal d=128", 1, 8, 2, 200, 333, 128, bf16, False,
         None),
        ("bf16 window 64", 1, 8, 2, 300, 300, 64, bf16, True, 64),
        ("bf16 causal GQA 4 d=128, Sk tail", 1, 8, 2, 200, 333, 128, bf16,
         True, None),
        ("bf16 rows without keys", 1, 4, 2, 150, 50, 64, bf16, True, None),
        ("bf16 causal GQA 4 d=96, Sk tail", 1, 8, 2, 200, 333, 96, bf16,
         True, None),
    ]
    errs = {"torch.float32": 0.0, "torch.bfloat16": 0.0}
    abs_errs, lse_errs = dict(errs), dict(errs)
    routes: dict = {}

    def note(dt, e):
        errs[dt] = max(errs[dt], e["dq"], e["dk"], e["dv"],
                       *e["simt_rel_rms"].values())
        abs_errs[dt] = max(abs_errs[dt], e["max_abs_err"],
                           e["simt_max_abs_err"])
        lse_errs[dt] = max(lse_errs[dt], e["lse_abs_err"])
        routes[e["route"]] = routes.get(e["route"], 0) + 1
        if e["simt_rel_rms"]:
            routes["simt"] = routes.get("simt", 0) + 1

    for case in cases:
        e, inputs = flash_bwd_check(dev, g, *case)
        note(str(case[7]), e)
        del inputs
    cfg_shape = (BATCH, 32, 8, PROMPT, PROMPT, 64)
    b, hq, hkv, sq, sk, d = cfg_shape
    e, (q, k, v, o, do, lse) = flash_bwd_check(
        dev, g, "llama3.2-1b training", b, hq, hkv, sq, sk, d, bf16, True,
        None, sdpa=True, simt=True)
    note("torch.bfloat16", e)
    if routes != {"wgmma": 5, "simt": 11} or e["route"] != "wgmma":
        raise AssertionError(f"flash backward checks by route {routes}")
    t0 = time.perf_counter()
    group = hq // hkv
    kernel = (lambda: bmod.flash_attention_bwd_kernel(
        q, k, v, o, do, lse, group=group, causal=True))
    simt = (lambda: bmod.simt_launch(q, k, v, o, do, lse, group=group,
                                     causal=True))
    q4, k4, v4, do4 = (t.reshape(b, -1, t.shape[1], d)
                       for t in (q, k, v, do))
    sdpa_bwd = sdpa_backward_call(q4, k4, v4, do4)
    (ms, simt_ms), graph_turns = in_turns(
        lambda fn: graph_ms(fn, reps=10, replays=3), (kernel, simt))
    (b2b, simt_b2b, lib), turns = in_turns(
        lambda fn: cuda_ms(fn, reps=10), (kernel, simt, sdpa_bwd))
    plain = cuda_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, do, lse, group), reps=3, warmup=1)
    bnd, by = flash_bwd_bound(b, hq, hkv, sq, sk, d, True, None, 2)
    floor, _ = flash_bwd_bound(b, hq, hkv, sq, sk, d, True, None, 2,
                               per_pair=14)
    # the forward, with and without its lse output, by graph replay
    (fwd_ms, fwd_lse_ms), fwd_turns = in_turns(
        lambda fn: graph_ms(fn, reps=50),
        (lambda: fmod.flash_attention_kernel(q, k, v, group=group),
         lambda: fmod.flash_attention_kernel(q, k, v, group=group,
                                             return_lse=True)))
    phase("flash backward timing llama3.2-1b training", t0,
          f"q=({b * hq}, {sq}, {d}) kv=({b * hkv}, {sk}, {d}) bf16 causal "
          f"graph, in turns: wgmma_ms={ms:.5f} simt_ms={simt_ms:.5f} "
          f"in_turns={['%.5f' % t for t in graph_turns]}; back to back, in "
          f"turns: wgmma_ms={b2b:.5f} simt_ms={simt_b2b:.5f} "
          f"sdpa_backward_ms={lib:.5f} in_turns="
          f"{['%.5f' % t for t in turns]}; wgmma/sdpa={b2b / lib:.4f}; "
          f"plain_ms={plain:.4f} bound_ms={bnd:.5f} ({by}, 10·D a pair) "
          f"share_of_bound={bnd / ms:.4f} design_floor_ms={floor:.5f} "
          f"(14·D a pair) pairs={b * hq * flash_pairs(sq, sk, True, None)}; "
          f"rel_rms_err wgmma="
          f"{json.dumps({w: e[w] for w in ('dq', 'dk', 'dv')})} "
          f"simt={json.dumps(e['simt_rel_rms'])} "
          f"sdpa={json.dumps(e['sdpa_rel_rms'])}; forward by graph: "
          f"without lse {fwd_ms:.5f} ms, with lse {fwd_lse_ms:.5f} ms, "
          f"in_turns={['%.5f' % t for t in fwd_turns]}")
    del q, k, v, o, do, lse, q4, k4, v4, do4, sdpa_bwd
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": FLASH_BWD_SOURCE, "replaces": FLASH_BWD_REPLACES,
            "launches": None, "max_abs_err": max(abs_errs.values()),
            "max_abs_err_by_dtype": abs_errs,
            "max_rel_rms_err": max(errs.values()),
            "max_rel_rms_err_by_dtype": errs, "checks_by_route": routes,
            "forward_lse_abs_err_by_dtype": lse_errs, "ms": ms,
            "timed": "CUDA graph replay, the wgmma route (the training "
            "shape's)", "ms_by_route": {"wgmma": ms, "simt": simt_ms},
            "back_to_back_ms": b2b,
            "back_to_back_ms_by_route": {"wgmma": b2b, "simt": simt_b2b},
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib, "library": "autograd "
            "of scaled_dot_product_attention(is_causal=True, "
            "enable_gqa=True)", "library_timed": "back to back",
            "library_rel_rms_err": e["sdpa_rel_rms"],
            "shape": {"q": [b, hq, sq, d], "kv": [b, hkv, sk, d],
                      "causal": True, "dtype": "bfloat16"},
            "forward_ms": {"without_lse": fwd_ms, "with_lse": fwd_lse_ms,
                           "timed": "CUDA graph replay"}}


def train_args(tmp: str, seed: int, steps: int = TRAIN_STEPS) -> list:
    """``launch/train.py``'s flags for the smoke's run: full config, batch
    BATCH x PROMPT, checkpoints in ``tmp``."""
    return ["--arch", ARCH, "--steps", str(steps), "--batch", str(BATCH),
            "--seq", str(PROMPT), "--lr", str(TRAIN_LR), "--warmup",
            str(TRAIN_WARMUP), "--ckpt-dir", tmp, "--ckpt-every",
            str(TRAIN_SAVE_AT), "--log-every", "1", "--seed", str(seed),
            "--device", "cuda"]


def grads_checked(opt, seen: list):
    """``opt`` whose update first records, for every leaf of the (clipped)
    gradients it is given, whether it holds a non-zero value."""
    from repro_torch.optim import Optimizer

    def update(grads, state, params, lr):
        import torch
        nonzero = torch.stack([g.ne(0).any() for g in grads.values()])
        seen.append(dict(zip(grads, nonzero.tolist())))
        return opt.update(grads, state, params, lr)

    return Optimizer(init=opt.init, update=update)


def timed_steps(step_fn, log: list):
    """``step_fn`` that records each step's host wall (after a
    synchronize), loss and grad norm, its flash and SSM-scan launches by
    route, and the caching allocator's retries (a failed cudaMalloc that
    frees the cache and tries again) and cudaMallocs in it."""
    import torch
    from repro_torch.kernels.flash_attention import backward as bmod
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.ssm_scan import backward as sbmod
    from repro_torch.kernels.ssm_scan import kernel as smod

    def step(state, batch):
        fwd0 = dict(fmod.LAUNCHES_BY_ROUTE)
        bwd0 = dict(bmod.LAUNCHES_BY_ROUTE)
        ssm0 = dict(smod.LAUNCHES_BY_ROUTE)
        ssm_bwd0 = sbmod.LAUNCHES
        mem0 = torch.cuda.memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        mem = torch.cuda.memory_stats()
        log.append({"step": int(state.step), "ms": ms,
                    "alloc_retries": mem["num_alloc_retries"]
                    - mem0["num_alloc_retries"],
                    "cuda_mallocs": mem.get("num_device_alloc", 0)
                    - mem0.get("num_device_alloc", 0),
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "flash_forward_by_route": {
                        r: fmod.LAUNCHES_BY_ROUTE[r] - fwd0[r]
                        for r in fwd0},
                    "flash_backward_by_route": {
                        r: bmod.LAUNCHES_BY_ROUTE[r] - bwd0[r]
                        for r in bwd0},
                    "ssm_forward_by_route": {
                        r: smod.LAUNCHES_BY_ROUTE[r] - ssm0[r]
                        for r in ssm0},
                    "ssm_backward": sbmod.LAUNCHES - ssm_bwd0})
        return state, metrics

    return step


def train_run(tmp: str, seed: int) -> tuple:
    """The main path: ``launch/train.py``'s setup and trainer at full
    width and depth, TRAIN_STEPS AdamW steps on one repeated batch,
    checkpointed at TRAIN_SAVE_AT; every launch counter read around it.
    The checkpoint's write is joined (``Trainer.run`` waits on it) and its
    dirty pages flushed (``os.sync``) before the steps after it are timed,
    and both are timed on their own.  Returns (the setup, the repeated
    batch, the step log, peak allocated bytes)."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.train import Trainer, TrainerConfig
    args = train.parser().parse_args(train_args(tmp, seed))
    t0 = time.perf_counter()
    run = train.setup(args)
    cfg = run.cfg
    batch = run.batch_fn(0)
    phase("train setup", t0,
          f"arch={ARCH} params="
          f"{sum(p.numel() for p in run.state.params.parameters())} "
          f"dtype={cfg.dtype} remat={cfg.remat} layers={cfg.num_layers}")
    log: list = []
    step = timed_steps(run.train_step, log)
    manager = CheckpointManager(tmp, keep=1)
    L = cfg.num_layers
    fwd_per_step = L * (2 if cfg.remat else 1)
    shape = flash_shape(BATCH, cfg.num_heads, cfg.num_kv_heads, PROMPT,
                        PROMPT, True, None)
    bwd_shape = shape  # the forward's route: wgmma
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launches()
    # steps 1..TRAIN_SAVE_AT, saved there; then on to TRAIN_STEPS on the
    # same state without a save (the checkpoint at TRAIN_SAVE_AT is kept
    # for the restart)
    first = Trainer(step, run.state, None, manager, TrainerConfig(
        total_steps=TRAIN_SAVE_AT, checkpoint_every=TRAIN_SAVE_AT,
        log_every=1), batch_fn=lambda s: batch)
    state = first.run()
    save_s = time.perf_counter() - t0 - sum(r["ms"] for r in log) / 1e3
    t1 = time.perf_counter()
    os.sync()
    sync_s = time.perf_counter() - t1
    rest = Trainer(step, state, None, manager, TrainerConfig(
        total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_STEPS + 1,
        log_every=1), batch_fn=lambda s: batch)
    state = rest.run()
    launches = read_launches(
        "train", {"flash_attention": fwd_per_step * TRAIN_STEPS,
                  "flash_attention_bwd": L * TRAIN_STEPS},
        flash_shapes={shape: fwd_per_step * TRAIN_STEPS},
        bwd_shapes={bwd_shape: L * TRAIN_STEPS})
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    run.state = state
    losses = [r["loss"] for r in log]
    if len(log) != TRAIN_STEPS or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}: not finite, or "
                             f"step {TRAIN_STEPS}'s not below step 1's")
    for r in log:
        if r["flash_forward_by_route"] != {"wgmma": fwd_per_step,
                                           "simt": 0} or \
                r["flash_backward_by_route"] != {"wgmma": L, "simt": 0}:
            raise AssertionError(f"step {r['step']}: flash launches "
                                 f"{r['flash_forward_by_route']}, backward "
                                 f"{r['flash_backward_by_route']}")
    for r in log:
        print(f"[train] step {r['step']} loss={r['loss']:.6f} grad_norm="
              f"{r['grad_norm']:.6f} step_ms={r['ms']:.3f} flash forward "
              f"by route {json.dumps(r['flash_forward_by_route'])} "
              f"backward by route "
              f"{json.dumps(r['flash_backward_by_route'])} alloc_retries="
              f"{r['alloc_retries']} cuda_mallocs={r['cuda_mallocs']}",
              flush=True)
    phase("train (main path)", t0,
          f"steps={TRAIN_STEPS} batch={BATCH}x{PROMPT} wall_s={wall:.3f} "
          f"peak_allocated_bytes={peak} losses={losses} grad_norms="
          f"{[r['grad_norm'] for r in log]} step_ms="
          f"{[round(r['ms'], 3) for r in log]} checkpoint at step "
          f"{TRAIN_SAVE_AT}: gather and write {save_s:.3f} s, then "
          f"os.sync {sync_s:.3f} s, neither inside a step's time; "
          f"launches={json.dumps(launches)}")
    return run, batch, log, peak


def train_restart(run, batch, tmp: str, seed: int) -> None:
    """A fresh state (another seed) restored from the step-TRAIN_SAVE_AT
    checkpoint runs the remaining steps on the same batch: its parameters
    and optimizer moments must equal the uninterrupted run's bit for bit.
    Its step records, outside any timed step, whether every leaf's
    gradient holds a non-zero value: the same gradients as the main
    path's steps, as the bit equality shows."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.optim import named_tree
    from repro_torch.optim.schedule import cosine_warmup
    from repro_torch.train import (StepConfig, Trainer, TrainerConfig,
                                   make_train_step)
    t0 = time.perf_counter()
    args = train.parser().parse_args(train_args(tmp, seed + 1))
    fresh = train.setup(args)
    manager = CheckpointManager(tmp, keep=1)
    if manager.latest_step() != TRAIN_SAVE_AT:
        raise AssertionError(f"checkpoints {sorted(manager.latest_steps())}")
    t1 = time.perf_counter()
    state = manager.restore(fresh.state, step=TRAIN_SAVE_AT)
    restore_s = time.perf_counter() - t1
    if int(state.step) != TRAIN_SAVE_AT:
        raise AssertionError(f"restored step {int(state.step)}")
    seen: list = []
    step = make_train_step(
        fresh.model, grads_checked(fresh.optimizer, seen),
        cosine_warmup(args.lr, args.warmup, args.steps),
        StepConfig(grad_sync=args.grad_sync, microbatch=args.microbatch))
    reset_launches()
    state = Trainer(step, state, None, manager, TrainerConfig(
        total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_STEPS + 1,
        log_every=1), batch_fn=lambda s: batch).run()
    cfg = run.cfg
    L, steps = cfg.num_layers, TRAIN_STEPS - TRAIN_SAVE_AT
    read_launches("train restart",
                  {"flash_attention": L * (2 if cfg.remat else 1) * steps,
                   "flash_attention_bwd": L * steps})
    want, got = named_tree(run.state.params), named_tree(state.params)
    diff = [k for k in want if not torch.equal(want[k], got[k])]
    for name in ("m", "v"):
        a = getattr(run.state.opt_state, name)
        b = getattr(state.opt_state, name)
        diff += [f"opt_state.{name}.{k}" for k in a
                 if not torch.equal(a[k], b[k])]
    if diff or int(state.step) != TRAIN_STEPS:
        raise AssertionError(f"restart at step {TRAIN_SAVE_AT}: "
                             f"{len(diff)} leaves differ from the "
                             f"uninterrupted run ({diff[:5]}), step "
                             f"{int(state.step)}")
    zero = sorted({k for s in seen for k, nz in s.items() if not nz})
    qkv = [k for k in seen[0] if k.split(".")[-1] in ("wq", "wk", "wv")]
    if len(seen) != steps or zero or len(qkv) != 3 * L or \
            len(seen[0]) != len(want):
        raise AssertionError(f"leaves with an all-zero gradient: {zero}; "
                             f"{len(qkv)} attention projections and "
                             f"{len(seen[0])} leaves seen in {len(seen)} "
                             f"steps")
    phase("train restart", t0,
          f"restored step {TRAIN_SAVE_AT} into a fresh state (seed "
          f"{seed + 1}) in {restore_s:.3f} s, ran steps "
          f"{TRAIN_SAVE_AT + 1}-{TRAIN_STEPS}: {len(want)} parameters and "
          f"{2 * len(want)} moments equal the uninterrupted run's bit for "
          f"bit; nonzero_grad_leaves={len(seen[0])} of {len(want)} in "
          f"each of steps {TRAIN_SAVE_AT + 1}-{TRAIN_STEPS} (wq/wk/wv: "
          f"{len(qkv)})")
    del fresh, state


def train_grad_check(seed: int) -> None:
    """At full width and TRAIN_GRAD_CHECK_LAYERS layers in f32: one
    batch's gradients through the kernels (flash forward on its f32
    route and the backward kernel) against the same loss with
    ``attn_impl="ref"``, leaf by leaf by relative norm."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import named_tree
    t0 = time.perf_counter()
    cfg = get_config(ARCH).scaled(num_layers=TRAIN_GRAD_CHECK_LAYERS,
                                  dtype="float32")
    model = build_model(cfg, device="cuda")
    ref_model = build_model(cfg.scaled(attn_impl="ref"), device="cuda")
    params = model.init(seed).trainable()
    batch = train.make_batch_fn(cfg, BATCH, PROMPT, seed,
                                model.device)(0)
    named = named_tree(params)
    grads = {}
    for name, m in (("kernel", model), ("ref", ref_model)):
        for p in named.values():
            p.grad = None
        if name == "kernel":
            reset_launches()
        loss, _ = m.loss(params, batch)
        loss.backward()
        if name == "kernel":
            L = cfg.num_layers
            read_launches("train grad check (f32)",
                          {"flash_attention": L * (2 if cfg.remat else 1),
                           "flash_attention_bwd": L}, flash_route="simt")
        grads[name] = ({k: p.grad for k, p in named.items()},
                       float(loss.detach()))
        for p in named.values():
            p.grad = None
    (gk, lk), (gr, lr_) = grads["kernel"], grads["ref"]
    rel = {k: float((gk[k] - gr[k]).norm() / gr[k].norm()) for k in gr}
    worst = max(rel, key=rel.get)
    if not rel[worst] <= TRAIN_GRAD_REL_TOL or any(
            float(g.norm()) == 0 for g in gr.values()):
        raise AssertionError(f"f32 gradients through the kernels differ "
                             f"from attn_impl='ref': {worst} "
                             f"{rel[worst]} > {TRAIN_GRAD_REL_TOL}")
    qkv = {k: v for k, v in rel.items()
           if k.split(".")[-1] in ("wq", "wk", "wv")}
    phase("train gradients vs plain attention (f32)", t0,
          f"layers={cfg.num_layers} d={cfg.d_model} batch={BATCH}x{PROMPT} "
          f"loss kernel={lk:.6f} ref={lr_:.6f} leaves={len(rel)} "
          f"max_rel_norm_err={rel[worst]:.3e} ({worst}) wq/wk/wv max="
          f"{max(qkv.values()):.3e} tol={TRAIN_GRAD_REL_TOL}")
    del grads, gk, gr, params


def train_slice(seed: int, tmp: str) -> dict:
    """The backward kernel's checks and timings, then Llama-3.2-1B
    training at full width and depth (the main path), its restart from a
    checkpoint in ``tmp`` (kept there for slice 10's elastic restore),
    and the f32 gradient check; returns the backward's JSON record."""
    import torch
    rec = flash_bwd_kernel_phase(torch.device("cuda"))
    torch.cuda.empty_cache()
    run, batch, log, peak = train_run(tmp, seed)
    WARM_STEP_MS[ARCH] = min(r["ms"] for r in log[1:])
    rec["launches"] = PATH_LAUNCHES["train"]["flash_attention_bwd"]
    rec["train"] = {"steps": log, "peak_allocated_bytes": peak}
    train_restart(run, batch, tmp, seed)
    del run, batch
    torch.cuda.empty_cache()
    train_grad_check(seed)
    return rec


# ---------------------------------------------------------------------------
# slice 9: hymba-1.5b training at full width and depth, through the
# selective scan's backward kernel
# ---------------------------------------------------------------------------

SSM_BWD_SOURCE = "src/repro_torch/csrc/ssm_scan_bwd.cu"
SSM_BWD_REPLACES = ("src/repro/kernels/ssm_scan/kernel.py:72 (its "
                    "gradient: the port's own kernel, as no pl.pallas_call "
                    "in the reference computes one and jax.grad through "
                    "this one raises; the reference trains through XLA's "
                    "autodiff of the chunked lax.scan in "
                    "src/repro/models/ssm.py:ssm_scan)")
#: Relative RMS error of each gradient against the plain backward taken in
#: f32 on the same inputs: f32 kernels differ from it in summation order
#: and in the MUFU's exp2 (2^-22 relative a step of the recurrence); bf16
#: xc gives dxc and dx_proj in bf16 (2^-9 relative rounding, ~1.1e-3 RMS),
#: the other gradients stay f32.
SSM_BWD_REL_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 5e-3}
#: One backward call at hymba's training shape allocates less than this
#: (outputs and scratch; the first design's h_t alone took 0.84 GB).
SSM_BWD_CALL_BYTES = 200_000_000
HYMBA_TRAIN_STEPS = 3
SSM_GRADS = ("dxc", "dx_proj", "ddt_bias", "da_log", "dh0")


def ssm_bwd_bound(b: int, t: int, d: int, n: int, itemsize: int):
    """(bound ms, by) of the scan's gradient
    (``repro_torch.kernels.work.ssm_bwd``: the forward's inputs, dy, dh and
    the saved rows and states read once, the five gradients written once,
    against 22 operations a state-step, 15 a channel-step and 4 (2n + 1)
    a channel-step for dxc and dx_proj at the CUDA cores' f32 peak)."""
    from repro_torch.kernels import work
    return work.ssm_bwd(b, t, d, n, itemsize).bound()


def ssm_bwd_mufu_floor_ms(b: int, t: int, d: int, n: int,
                          chunk: int) -> tuple:
    """(the floor of the scan design: one exp2 a state-step, whose a
    serves both scans, and a softplus and a sigmoid, two each, a
    channel-step; the floor of the first design, which walks the steps
    twice, n + 2 transcendentals a channel-step forward and n + 3 back, and
    also runs the chunk-local walk back over every chunk but the first and
    an exp a state and chunk end), at MUFU_PER_S."""
    nc = -(-t // chunk)
    scan = b * d * t * (n + 4)
    rerun = b * d * t * (2 * n + 5) \
        + b * d * (n + 2) * (t - min(t, chunk)) + b * d * n * (nc - 1)
    return scan / MUFU_PER_S * 1e3, rerun / MUFU_PER_S * 1e3


def kernel_name(key: str) -> str:
    """A profiler row's kernel name without its namespace, template
    arguments and parameters (``ssm_bwd_scan`` of ``void (anonymous
    namespace)::ssm_bwd_scan<__nv_bfloat16, 16>(...)``)."""
    m = re.search(r"(\w+)\s*[<(]", key.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else key


def device_ms_by_kernel(fn) -> dict:
    """Device ms of each kernel one call of ``fn`` launches, by name, from
    ``torch.profiler`` (the card's rows only), after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == cuda and e.self_device_time_total > 0:
            name = kernel_name(e.key)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return out


def grad_errors(name: str, got, want, tol: float) -> tuple:
    """Per-gradient relative RMS error (``||got - want|| / ||want||`` in
    f32) and the largest absolute error; raises past ``tol``, on a dtype or
    shape other than the plain version's, or on a value that is not
    finite."""
    import torch
    errs, abs_err = {}, 0.0
    for what, x, y in zip(SSM_GRADS, got, want):
        if x.shape != y.shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"ssm backward {name} {what}: {x.dtype}"
                                 f"{tuple(x.shape)} against {y.dtype}"
                                 f"{tuple(y.shape)}, or not finite")
        diff = x.float() - y.float()
        errs[what] = float(diff.norm() / y.float().norm().clamp_min(1e-30))
        abs_err = max(abs_err, float(diff.abs().max()))
    if not max(errs.values()) <= tol:
        raise AssertionError(f"ssm backward {name}: relative RMS errors "
                             f"{errs} > {tol}")
    return errs, abs_err


def ssm_bwd_check(dev, g, name, b, t, d, n, dtype, carried: bool,
                  **shifts) -> tuple:
    """The forward on its chunked route saving its states, then two
    backward launches (the same bytes, asserted on the launch counts),
    held per gradient to the plain backward taken in f32 on the same
    inputs.  ``carried`` gives h0 and dh random values (else zero, as in
    training); ``shifts`` go to :func:`ssm_inputs`.  Returns (errors,
    the kernels' inputs)."""
    import torch
    from repro_torch.kernels.ssm_scan import backward as sbmod
    from repro_torch.kernels.ssm_scan import kernel as smod
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    t0 = time.perf_counter()
    args = ssm_inputs(dev, g, b, t, d, n, dtype, carried, **shifts)
    dy = torch.randn((b, t, d), device=dev, generator=g)
    dh = torch.randn((b, d, n), device=dev, generator=g) if carried else \
        torch.zeros((b, d, n), device=dev)
    before = (smod.LAUNCHES_BY_ROUTE["chunked"], sbmod.LAUNCHES)
    _, _, saved = smod.ssm_scan_kernel(*args, save=True)
    got = sbmod.ssm_scan_bwd_kernel(*args, dy, dh, *saved)
    again = sbmod.ssm_scan_bwd_kernel(*args, dy, dh, *saved)
    torch.cuda.synchronize()
    moved = (smod.LAUNCHES_BY_ROUTE["chunked"] - before[0],
             sbmod.LAUNCHES - before[1])
    if moved != (1, 2):
        raise AssertionError(f"ssm backward {name}: chunked forward and "
                             f"backward launches {moved}, expected (1, 2)")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"ssm backward {name}: two launches differ")
    if tuple(x.dtype for x in got) != (dtype, dtype) + (torch.float32,) * 3:
        raise AssertionError(f"ssm backward {name}: dtypes "
                             f"{[x.dtype for x in got]}")
    want = ssm_scan_bwd_ref(*(a.float() for a in args), dy, dh)
    tol = SSM_BWD_REL_TOL[str(dtype)]
    errs, abs_err = grad_errors(name, got, want, tol)
    del want, again, got
    phase(f"ssm backward check {name}", t0,
          f"xc={(b, t, d)} {dtype} n={n} carried_h0_dh={carried} "
          f"{json.dumps(shifts)} rel_rms_err={json.dumps(errs)} tol={tol} "
          f"max_abs_err={abs_err} deterministic=True")
    return {**errs, "max_abs_err": abs_err}, (*args, dy, dh, *saved)


def ssm_bwd_kernel_phase(dev, d: int, n: int) -> dict:
    """The SSM backward kernel against its plain version at hymba's
    training shape (bf16 and f32, h0 and dh zero as in training) and at
    the edges (spans, channel groups), each launched twice to the same
    bytes; at the training shape held to the first design too and timed
    in turns with it by CUDA-graph replay, beside the plain version, the
    bound and both designs' MUFU floors, with device time by kernel and
    one call's allocation (under ``SSM_BWD_CALL_BYTES``).  Returns the
    kernel's JSON record."""
    import torch
    from repro_torch.kernels.ssm_scan import backward as sbmod
    from repro_torch.kernels.ssm_scan import kernel as smod
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    bf16, f32 = torch.bfloat16, torch.float32
    L = smod.CHUNK
    S, G = sbmod.SPAN, sbmod.GROUP
    g = torch.Generator(device=dev).manual_seed(61)
    cases = [
        # name, b, t, d, n, xc dtype, carried h0 and dh, shifts
        ("training f32", BATCH, PROMPT, d, n, f32, False, {}),
        ("carried h0 and dh, f32", 2, 300, d, n, f32, True, {}),
        ("T=1", 2, 1, d, n, bf16, True, {}),
        ("T=7", 2, 7, 80, n, f32, True, {}),
        (f"T=L-1={L - 1}", 2, L - 1, d, n, bf16, True, {}),
        (f"T=L={L}", 2, L, d, n, f32, True, {}),
        (f"T=L+1={L + 1}", 2, L + 1, d, n, bf16, True, {}),
        (f"T={PROMPT}+17", BATCH, PROMPT + 17, d, n, bf16, True, {}),
        (f"T=2 spans-1={2 * S - 1}", 2, 2 * S - 1, d, n, bf16, True, {}),
        (f"T=2 spans+1={2 * S + 1}", 2, 2 * S + 1, d, n, f32, True, {}),
        (f"d=200 (not a multiple of the {G}-channel group)", 2, 300, 200,
         n, bf16, True, {}),
        ("d=1001 (not a multiple of the block)", 3, 300, 1001, n, bf16,
         True, {}),
        ("n=2", 2, 300, 37, 2, f32, True, {}),
        ("n=5 (not a power of two)", 1, 140, 9, 5, f32, True, {}),
        ("n=8", 2, 300, 80, 8, bf16, True, {}),
        ("dt past softplus's threshold", 2, 300, 80, n, f32, True,
         {"dt_shift": 25.0}),
        ("a underflows to 0", 2, 300, 80, n, f32, True,
         {"dt_shift": 3.0, "a_shift": 6.0}),
    ]
    errs = {"torch.float32": 0.0, "torch.bfloat16": 0.0}
    abs_errs = dict(errs)
    for name, b, t, dd, nn, dt, carried, shifts in cases:
        e, inputs = ssm_bwd_check(dev, g, name, b, t, dd, nn, dt, carried,
                                  **shifts)
        errs[str(dt)] = max(errs[str(dt)], *(e[k] for k in SSM_GRADS))
        abs_errs[str(dt)] = max(abs_errs[str(dt)], e["max_abs_err"])
        del inputs
    e, inputs = ssm_bwd_check(dev, g, "training bf16", BATCH, PROMPT, d, n,
                              bf16, False)
    errs["torch.bfloat16"] = max(errs["torch.bfloat16"],
                                 *(e[k] for k in SSM_GRADS))
    abs_errs["torch.bfloat16"] = max(abs_errs["torch.bfloat16"],
                                     e["max_abs_err"])
    # the first design on the same inputs: within the route's tolerance of
    # it, then both timed in turns by graph replay
    t0 = time.perf_counter()
    new = sbmod.ssm_scan_bwd_kernel(*inputs)
    old = sbmod.rerun_launch(*inputs)
    vs_rerun, _ = grad_errors("scan vs the first design", new, old,
                              SSM_BWD_REL_TOL["torch.bfloat16"])
    del new, old
    (ms, rerun_ms), turns = in_turns(
        lambda fn: graph_ms(fn, reps=10, replays=3),
        [lambda: sbmod.ssm_scan_bwd_kernel(*inputs),
         lambda: sbmod.rerun_launch(*inputs)])
    b2b = cuda_ms(lambda: sbmod.ssm_scan_bwd_kernel(*inputs), reps=10)
    fwd_ms = graph_ms(lambda: smod.ssm_scan_kernel(*inputs[:5], save=True),
                      reps=10, replays=3)
    plain = cuda_ms(lambda: ssm_scan_bwd_ref(*inputs[:7]), reps=2,
                    warmup=1)
    by_kernel = device_ms_by_kernel(
        lambda: sbmod.ssm_scan_bwd_kernel(*inputs))
    rerun_by_kernel = device_ms_by_kernel(
        lambda: sbmod.rerun_launch(*inputs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sbmod.ssm_scan_bwd_kernel(*inputs)
    torch.cuda.synchronize()
    call_bytes = torch.cuda.max_memory_allocated() - base
    if not call_bytes < SSM_BWD_CALL_BYTES:
        raise AssertionError(f"ssm backward: one call at the training shape "
                             f"allocates {call_bytes} B, not under "
                             f"{SSM_BWD_CALL_BYTES}")
    bnd, by = ssm_bwd_bound(BATCH, PROMPT, d, n, 2)
    floor, rerun_floor = ssm_bwd_mufu_floor_ms(BATCH, PROMPT, d, n, L)
    phase("ssm backward timing training bf16", t0,
          f"xc=({BATCH}, {PROMPT}, {d}) n={n} graph_ms={ms:.5f} "
          f"first_design_graph_ms={rerun_ms:.5f} (in turns: "
          f"{[round(v, 5) for v in turns]}) back_to_back_ms={b2b:.5f} "
          f"forward_with_saved_states_graph_ms={fwd_ms:.5f} plain_ms="
          f"{plain:.4f} bound_ms={bnd:.5f} ({by}) share_of_bound="
          f"{bnd / ms:.4f} mufu_floor_ms={floor:.5f} first_design_mufu_"
          f"floor_ms={rerun_floor:.5f} call_allocated_bytes={call_bytes} "
          f"(limit {SSM_BWD_CALL_BYTES}) device_ms_by_kernel="
          f"{json.dumps(by_kernel)} first_design_device_ms_by_kernel="
          f"{json.dumps(rerun_by_kernel)} rel_rms_vs_first_design="
          f"{json.dumps(vs_rerun)}; library: none")
    del inputs
    return {"name": "ssm_scan_bwd", "route": "cuda",
            "source": SSM_BWD_SOURCE, "replaces": SSM_BWD_REPLACES,
            "launches": None, "max_abs_err": max(abs_errs.values()),
            "max_abs_err_by_dtype": abs_errs,
            "max_rel_rms_err": max(errs.values()),
            "max_rel_rms_err_by_dtype": errs, "ms": ms,
            "timed": "CUDA graph replay, training shape bf16",
            "first_design_ms": rerun_ms, "back_to_back_ms": b2b,
            "forward_with_saved_states_ms": fwd_ms,
            "device_ms_by_kernel": by_kernel,
            "first_design_device_ms_by_kernel": rerun_by_kernel,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "call_allocated_bytes": call_bytes, "library_ms": None,
            "library": "none: no single PyTorch call computes a selective "
                       "scan's gradient",
            "shape": {"xc": [BATCH, PROMPT, d], "n": n, "dtype": "bfloat16"}}


def hymba_flash_bwd(dev, cfg) -> dict:
    """The flash backward at hymba's two training shapes (GQA group 5,
    causal, window 1024 and global), held like the Llama shape's and timed
    by CUDA-graph replay; returns {window: ms}."""
    from repro_torch.kernels.flash_attention import backward as bmod
    import torch
    g = torch.Generator(device=dev).manual_seed(62)
    out = {}
    for w in (cfg.window, None):
        e, (q, k, v, o, do, lse) = flash_bwd_check(
            dev, g, f"hymba training window={w}", BATCH, cfg.num_heads,
            cfg.num_kv_heads, PROMPT, PROMPT, cfg.hd, torch.bfloat16, True, w)
        if e["route"] != "wgmma":
            raise AssertionError(f"flash backward at hymba's shape: route "
                                 f"{e['route']}")
        t0 = time.perf_counter()
        group = cfg.num_heads // cfg.num_kv_heads
        out[str(w)] = graph_ms(lambda: bmod.flash_attention_bwd_kernel(
            q, k, v, o, do, lse, group=group, causal=True, window=w),
            reps=10, replays=3)
        bnd, by = flash_bwd_bound(BATCH, cfg.num_heads, cfg.num_kv_heads,
                                  PROMPT, PROMPT, cfg.hd, True, w, 2)
        errs = {x: e[x] for x in ("dq", "dk", "dv")}
        phase(f"flash backward timing hymba window={w}", t0,
              f"graph_ms={out[str(w)]:.5f} bound_ms={bnd:.5f} ({by}) "
              f"rel_rms_err={json.dumps(errs)}")
        del q, k, v, o, do, lse
    return out


def hymba_train_args(tmp: str, seed: int,
                     steps: int = HYMBA_TRAIN_STEPS) -> list:
    """``launch/train.py``'s flags for hymba's run: full config, batch
    BATCH x PROMPT, ``steps`` steps, no checkpoint (``--ckpt-every`` past
    the last step)."""
    return ["--arch", HYBRID_ARCH, "--steps", str(steps), "--batch",
            str(BATCH), "--seq", str(PROMPT), "--lr", str(TRAIN_LR),
            "--warmup", str(TRAIN_WARMUP), "--ckpt-dir", tmp, "--ckpt-every",
            str(steps + 1), "--log-every", "1", "--seed", str(seed),
            "--device", "cuda"]


def hymba_train_run(tmp: str, seed: int) -> tuple:
    """The main path: ``launch/train.py``'s setup and trainer at hymba's
    full width and depth, HYMBA_TRAIN_STEPS AdamW steps on one repeated
    batch, every launch counter read around them.  Returns (the step log,
    peak allocated bytes)."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf
    from repro_torch.train import Trainer, TrainerConfig
    args = train.parser().parse_args(hymba_train_args(tmp, seed))
    t0 = time.perf_counter()
    run = train.setup(args)
    cfg = run.cfg
    batch = run.batch_fn(0)
    params = sum(p.numel() for p in run.state.params.parameters())
    if params != HYMBA_PARAMS:
        raise AssertionError(f"{params} parameters, expected {HYMBA_PARAMS}")
    phase("hymba train setup", t0,
          f"arch={HYBRID_ARCH} params={params} dtype={cfg.dtype} "
          f"remat={cfg.remat} layers={cfg.num_layers}")
    L = cfg.num_layers
    per = 2 if cfg.remat else 1
    windows = [tf.layer_window(cfg, i) for i in range(L)]
    shapes = {}
    for w in windows:
        key = flash_shape(BATCH, cfg.num_heads, cfg.num_kv_heads, PROMPT,
                          PROMPT, True, w)
        shapes[key] = shapes.get(key, 0) + HYMBA_TRAIN_STEPS
    log: list = []
    step = timed_steps(run.train_step, log)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launches()
    Trainer(step, run.state, None, CheckpointManager(tmp, keep=1),
            TrainerConfig(total_steps=args.steps,
                          checkpoint_every=args.ckpt_every,
                          log_every=1), batch_fn=lambda s: batch).run()
    launches = read_launches(
        f"{HYBRID_ARCH} train",
        {"ssm_scan": L * per * HYMBA_TRAIN_STEPS,
         "ssm_scan_bwd": L * HYMBA_TRAIN_STEPS,
         "flash_attention": L * per * HYMBA_TRAIN_STEPS,
         "flash_attention_bwd": L * HYMBA_TRAIN_STEPS},
        ssm_routes={"chunked": L * per * HYMBA_TRAIN_STEPS},
        flash_shapes={k: v * per for k, v in shapes.items()},
        bwd_shapes=shapes)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in log]
    if len(log) != HYMBA_TRAIN_STEPS or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"hymba training losses {losses}: not finite, "
                             f"or the last not below the first")
    for r in log:
        if (r["flash_forward_by_route"] != {"wgmma": L * per, "simt": 0}
                or r["flash_backward_by_route"] != {"wgmma": L, "simt": 0}
                or r["ssm_forward_by_route"] != {"chunked": L * per,
                                                 "step": 0}
                or r["ssm_backward"] != L):
            raise AssertionError(f"hymba step {r['step']}: launches {r}")
        print(f"[hymba train] step {r['step']} loss={r['loss']:.6f} "
              f"grad_norm={r['grad_norm']:.6f} step_ms={r['ms']:.3f} ssm "
              f"forward by route {json.dumps(r['ssm_forward_by_route'])} "
              f"backward {r['ssm_backward']} flash forward by route "
              f"{json.dumps(r['flash_forward_by_route'])} backward by route "
              f"{json.dumps(r['flash_backward_by_route'])} alloc_retries="
              f"{r['alloc_retries']} cuda_mallocs={r['cuda_mallocs']}",
              flush=True)
    phase("hymba train (main path)", t0,
          f"steps={HYMBA_TRAIN_STEPS} batch={BATCH}x{PROMPT} wall_s="
          f"{wall:.3f} peak_allocated_bytes={peak} losses={losses} "
          f"grad_norms={[r['grad_norm'] for r in log]} step_ms="
          f"{[round(r['ms'], 3) for r in log]} "
          f"launches={json.dumps(launches)}")
    del run, batch
    return log, peak


def ssm_scan_f64(xc, x_proj, dt_bias, a_log, h0):
    """The sequential recurrence of ``ssm_scan_ref`` in float64 on every
    input (y [B, T, d], h_final [B, d, n] in float64), differentiable: the
    witnesses' scan with next to no rounding."""
    import torch
    n = a_log.shape[1]
    xf = xc.double()
    proj = xf @ x_proj.double()
    bb, cc, dtr = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n]
    dt = torch.logaddexp(dtr[..., None] + dt_bias.double(), xf.new_zeros(()))
    a = torch.exp(-torch.exp(a_log.double()) * dt[..., None])
    bx = (dt * xf)[..., None] * bb[..., None, :]
    h, ys = h0.double(), []
    for a_t, bx_t, c_t in zip(a.unbind(1), bx.unbind(1), cc.unbind(1)):
        h = a_t * h + bx_t
        ys.append(torch.einsum("bdn,bn->bd", h, c_t))
    return torch.stack(ys, dim=1), h


def witness_scans() -> dict:
    """Stand-ins for ``ops.ssm_scan_fused`` on the model's path (same
    arguments), for :func:`hymba_grad_check`'s witnesses: ``"plain"``, the
    SSM kernels' plain versions (``ssm_scan_ref`` forward,
    ``ssm_scan_bwd_ref`` backward, f32), ``"f64"``,
    :func:`ssm_scan_f64` with its results cast to f32, and ``"tapped"``,
    which given a list returns the kernels' op keeping each call's inputs
    and y's gradient in it."""
    import torch
    from repro_torch.kernels.ssm_scan.ref import (ssm_scan_bwd_ref,
                                                  ssm_scan_ref)

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return ssm_scan_ref(*args)

        @staticmethod
        def backward(ctx, dy, dh):
            args = ctx.saved_tensors
            xc, h0 = args[0], args[4]
            dy = torch.zeros(xc.shape, device=xc.device) if dy is None \
                else dy
            dh = torch.zeros(h0.shape, device=h0.device) if dh is None \
                else dh
            return ssm_scan_bwd_ref(*args, dy, dh)

    class Tap(torch.autograd.Function):
        """y unchanged; its backward appends (the scan's inputs, y's
        gradient) to ``sink``."""

        @staticmethod
        def forward(ctx, y, args, sink):
            ctx.args, ctx.sink = args, sink
            return y.view_as(y)

        @staticmethod
        def backward(ctx, dy):
            ctx.sink.append((ctx.args, dy.detach().clone()))
            return dy, None, None

    def tapped(sink: list):
        from repro_torch.kernels.ssm_scan.ops import ssm_scan_fused

        def scan(*args, chunk=None):
            y, h = ssm_scan_fused(*args, chunk=chunk)
            return Tap.apply(y, tuple(a.detach().contiguous() for a in args),
                             sink), h
        return scan

    return {"plain": lambda *args, chunk=None: Plain.apply(*args),
            "f64": lambda *args, chunk=None: tuple(
                v.float() for v in ssm_scan_f64(*args)),
            "tapped": tapped}


def ssm_bwd_vs_f64(name: str, args: tuple, dy, dh) -> dict:
    """The SSM backward kernel (after the forward saving its states) and
    its plain version, both in f32 on ``args`` (xc, x_proj, dt_bias, a_log,
    h0), ``dy`` and ``dh``, each held per gradient by relative norm to
    autograd of :func:`ssm_scan_f64` on the same inputs; the kernel within
    ``SSM_BWD_REL_TOL`` f32.  Returns {"kernel": errors, "plain":
    errors}."""
    import torch
    from repro_torch.kernels.ssm_scan import backward as sbmod
    from repro_torch.kernels.ssm_scan import kernel as smod
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    t0 = time.perf_counter()
    _, _, saved = smod.ssm_scan_kernel(*args, save=True)
    got = {"kernel": sbmod.ssm_scan_bwd_kernel(*args, dy, dh, *saved),
           "plain": ssm_scan_bwd_ref(*args, dy, dh)}
    del saved
    leaves = [a.double().requires_grad_() for a in args]
    y, h = ssm_scan_f64(*leaves)
    want = torch.autograd.grad((y, h), leaves, (dy.double(), dh.double()))
    del y, h, leaves
    errs = {side: {what: float((x.double() - w).norm() / w.norm())
                   for what, x, w in zip(SSM_GRADS, grads, want)
                   if float(w.norm()) > 0}
            for side, grads in got.items()}
    tol = SSM_BWD_REL_TOL["torch.float32"]
    if not max(errs["kernel"].values()) <= tol:
        raise AssertionError(f"ssm backward against the scan in f64, "
                             f"{name}: {errs} > {tol}")
    phase(f"ssm backward against the scan in f64, {name}", t0,
          f"xc={tuple(args[0].shape)} {args[0].dtype} "
          f"n={args[3].shape[1]} rel_norm_err={json.dumps(errs)} tol={tol}")
    return errs


def hymba_grad_check(seed: int) -> dict:
    """At full width and TRAIN_GRAD_CHECK_LAYERS layers (layer 0 global,
    layer 1 windowed) in f32: one batch's gradients through the kernels
    (the SSM scan and its backward, flash on its f32 route and its
    backward) against the same loss through the reference's chunked scan
    and ``attn_impl="ref"``, leaf by leaf by relative norm.

    Then the witnesses, each with ``attn_impl="ref"`` so that only the scan
    differs: the SSM kernels, their plain versions (:func:`witness_scans`)
    and the scan in float64.  Each f32 run's distance from the f64 run is
    the share of the gap that its own scan's rounding carries; the kernels
    against their plain versions is what the kernels add to their
    algorithm; the kernels' runs with and without flash is the attention's
    share.  These readings are printed, not bounded: at this depth f32
    rounding alone moves a leaf by 5e-5 to 3e-4 (the plain versions lie
    farthest from f64), so a bound on them measures rounding.  The kernel
    is held to the f64 scan at the op instead, at the inputs and the
    gradient of y that each layer's scan met in the kernels' run
    (:func:`ssm_bwd_vs_f64`); returns those errors by layer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.optim import named_tree
    t0 = time.perf_counter()
    cfg = get_config(HYBRID_ARCH).scaled(
        num_layers=TRAIN_GRAD_CHECK_LAYERS, global_layers=(0,),
        dtype="float32")
    model = build_model(cfg, device="cuda")
    ref_model = build_model(cfg.scaled(attn_impl="ref"), device="cuda")
    params = model.init(seed).trainable()
    batch = train.make_batch_fn(cfg, BATCH, PROMPT, seed,
                                model.device)(0)
    named = named_tree(params)
    L = cfg.num_layers
    per = 2 if cfg.remat else 1
    path = f"{HYBRID_ARCH} train grad check (f32)"
    ssm_kernels = {"ssm_scan": L * per, "ssm_scan_bwd": L}
    flash = {"flash_attention": L * per, "flash_attention_bwd": L}
    stand_ins = witness_scans()
    taps: list = []
    runs = [
        # name, model, scan route, stand-in for ssm_scan_fused, launches
        ("kernel", model, "kernel", None, {**ssm_kernels, **flash}),
        ("ref", ref_model, "chunked", None, {}),
        ("kernel, attn ref", ref_model, "kernel", stand_ins["tapped"](taps),
         ssm_kernels),
        ("plain", ref_model, "kernel", stand_ins["plain"], {}),
        ("f64", ref_model, "kernel", stand_ins["f64"], {}),
    ]
    kernel_route, fused = ssm_lib.resolve_scan_impl, ssm_lib.ssm_scan_fused
    grads = {}
    for name, m, scan, stand_in, expect in runs:
        for p in named.values():
            p.grad = None
        try:
            ssm_lib.resolve_scan_impl = lambda device, scan=scan: scan
            ssm_lib.ssm_scan_fused = stand_in or fused
            reset_launches()
            loss, _ = m.loss(params, batch)
            loss.backward()
            read_launches(path if name == "kernel" else f"{path}, {name}",
                          expect, flash_route="simt",
                          ssm_routes={"chunked": L * per} if expect.get(
                              "ssm_scan") else None)
        finally:
            ssm_lib.resolve_scan_impl, ssm_lib.ssm_scan_fused = \
                kernel_route, fused
        grads[name] = ({k: p.grad for k, p in named.items()},
                       float(loss.detach()))
        for p in named.values():
            p.grad = None

    def rel(a: str, b: str) -> dict:
        return {k: float((grads[a][0][k] - grads[b][0][k]).norm()
                         / grads[b][0][k].norm()) for k in grads[b][0]}

    gap = rel("kernel", "ref")
    worst = max(gap, key=gap.get)
    if not gap[worst] <= TRAIN_GRAD_REL_TOL or any(
            float(g.norm()) == 0 for g in grads["ref"][0].values()):
        raise AssertionError(f"f32 gradients through the kernels differ "
                             f"from the chunked scan and attn_impl='ref': "
                             f"{worst} {gap[worst]} > {TRAIN_GRAD_REL_TOL}")
    ssm = {k: v for k, v in gap.items() if ".ssm." in f".{k}."}
    phase("hymba train gradients vs chunked scan (f32)", t0,
          f"layers={L} (global {list(cfg.global_layers)}) d={cfg.d_model} "
          f"batch={BATCH}x{PROMPT} loss kernel={grads['kernel'][1]:.6f} "
          f"ref={grads['ref'][1]:.6f} leaves={len(gap)} max_rel_norm_err="
          f"{gap[worst]:.3e} ({worst}) ssm leaves max={max(ssm.values()):.3e}"
          f" ({json.dumps({k: round(v, 9) for k, v in ssm.items()})}) "
          f"tol={TRAIN_GRAD_REL_TOL}")
    t0 = time.perf_counter()
    pairs = [("kernel", "ref"), ("kernel, attn ref", "ref"),
             ("kernel, attn ref", "f64"), ("ref", "f64"), ("plain", "f64"),
             ("kernel, attn ref", "plain"), ("kernel", "kernel, attn ref")]
    readings = {}
    for a, b in pairs:
        r = rel(a, b)
        top = max(r, key=r.get)
        readings[f"{a} vs {b}"] = {
            "max": r[top], "leaf": top,
            "ssm_max": max(v for k, v in r.items() if ".ssm." in f".{k}."),
            "other_max": max(v for k, v in r.items()
                             if ".ssm." not in f".{k}.")}
    if not all(np.isfinite(v["max"]) for v in readings.values()):
        raise AssertionError(f"hymba gradient witnesses: {readings}")
    phase("hymba train gradient witnesses (f32, scan in f64)", t0,
          f"losses={json.dumps({k: v[1] for k, v in grads.items()})} "
          f"rel_norm_err={json.dumps(readings)}")
    del grads, params
    # the backward's own share: each layer's scan at the inputs the model
    # gave it (the backward meets layer L-1 first)
    if len(taps) != L:
        raise AssertionError(f"{len(taps)} scans tapped, expected {L}")
    at_inputs = {}
    for i, (args, dy) in zip(range(L - 1, -1, -1), taps):
        dh = torch.zeros(args[4].shape, device=dy.device)
        at_inputs[f"layer {i}"] = ssm_bwd_vs_f64(
            f"hymba layer {i}, the model's inputs", args, dy, dh)
    return at_inputs


def hymba_train_slice(seed: int) -> dict:
    """The SSM backward kernel's checks and timing, the flash backward at
    hymba's shapes, then hymba-1.5b training at full width and depth (the
    main path), the f32 gradient check with its witnesses and the backward
    against the scan in f64; returns the SSM backward's JSON record."""
    import torch
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    cfg = get_config(HYBRID_ARCH)
    rec = ssm_bwd_kernel_phase(dev, cfg.d_model * max(cfg.ssm_expand, 1),
                               cfg.ssm_state)
    rec["flash_backward_hymba_ms"] = hymba_flash_bwd(dev, cfg)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hymba_")
    try:
        log, peak = hymba_train_run(tmp, seed)
        WARM_STEP_MS[HYBRID_ARCH] = min(r["ms"] for r in log[1:])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["launches"] = PATH_LAUNCHES[f"{HYBRID_ARCH} train"]["ssm_scan_bwd"]
    rec["train"] = {"steps": log, "peak_allocated_bytes": peak}
    torch.cuda.empty_cache()
    vs_f64 = hymba_grad_check(seed)
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(63)
    args = ssm_inputs(dev, g, BATCH, PROMPT, cfg.d_model * max(
        cfg.ssm_expand, 1), cfg.ssm_state, torch.float32, True)
    dy = torch.randn(args[0].shape, device=dev, generator=g)
    dh = torch.randn(args[4].shape, device=dev, generator=g)
    vs_f64["training shape, carried h0 and dh"] = ssm_bwd_vs_f64(
        "training shape, carried h0 and dh", args, dy, dh)
    rec["rel_norm_err_vs_f64"] = vs_f64
    return rec


# ---------------------------------------------------------------------------
# slice 8: xlstm-1.3b serving at full width and depth
# ---------------------------------------------------------------------------

SSM_FAMILY_ARCH = "xlstm-1.3b"


def xlstm_slice(seed: int) -> None:
    """xlstm-1.3b serving at full width and depth (48 blocks in units of 7
    mLSTM + 1 sLSTM, d_model 2048, 4 heads, vocab 50304, bf16): batch
    BATCH, PROMPT-token prompt, GEN greedy tokens through
    ``prefill_ssm`` and the xlstm decode step.  It runs no kernel (the
    reference has none for it): every counter stays 0.  Then the warm
    repeat and the teacher-forced check."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config(SSM_FAMILY_ARCH)
    m_per, units = tf._xlstm_unit_shape(cfg)
    run, _ = serve_smoke(SSM_FAMILY_ARCH, seed, {},
                         extra=f"layers={cfg.num_layers} units={units} "
                               f"mlstm_per_unit={m_per} slstm_steps_per_"
                               f"prefill={units * PROMPT}")
    check_run(run, cfg)
    kinds = [c.kind for c in run.cache]
    if kinds != (["mlstm"] * m_per + ["slstm"]) * units:
        raise AssertionError(f"xlstm caches {kinds}")
    warm_repeat(run)
    teacher_forced(run, launches=dict(path=f"{SSM_FAMILY_ARCH} forward",
                                      expect={}))


# ---------------------------------------------------------------------------
# slice 10: the mesh — its shards on one card, run one after another
# ---------------------------------------------------------------------------

CP_MESH = ((1, 8), ("data", "model"))         # eight sequence shards
EP_MESH = ((2, 4), ("data", "model"))         # 8 experts a shard, f_shard 2
DP_MESH = ((4,), ("data",))                   # one sequence a shard
POD_MESH = ((2, 2), ("pod", "data"))
ELASTIC_MESH = ((2, 2), ("data", "model"))
EP_NO_DROP_CF = 8.0              # no token copy drops at this capacity
MOE_MODES = ("weight_gather", "token_gather")
#: The gradient syncs against the fused step: one AdamW step (constant lr
#: SYNC_LR) of each of SYNCS from the same state and batch as a fused
#: step.  The loss within SYNC_LOSS_TOL of the fused step's.  The
#: gradients each step hands AdamW (clipped), leaf by leaf, within
#: SYNC_GRAD_TOL of the leaf's largest |g|, and the pre-clip gradient norm
#: within SYNC_NORM_TOL of its reference (both relative; clipping hides a
#: wrong scale from the gradients, not from the norm): an exact sync's
#: reference is the fused step, the int8 codec's is its plain version
#: (each shard's gradients through the codec from a zero residual, added
#: in f32 in shard order, over the shard count), whose sums are f32 in
#: both runs.  A bf16 gradient is rounded to 8 significant bits in each
#: shard's backward, at each level of the tree and in the fused backward:
#: SYNC_GRAD_TOL["bfloat16"] allows four units in the last place of the
#: leaf's largest |g|.  On the f32 copy the parameters are held too: every
#: one within SYNC_PARAM_TOL (the bound of the reference's
#: ``tests/distributed/grad_sync.py``) of the fused step that takes the
#: same four sequences one at a time (``StepConfig(microbatch=...)``: the
#: shards' kernel shapes, accumulated in order), and within SYNC_PARAM_TOL
#: of the whole-batch fused step's where that step's gradient is at or
#: above SYNC_GRAD_FLOOR.  Below the floor AdamW's first step
#: ``lr * g / (|g| + eps)`` (eps 1e-8) turns the f32 rounding of a gradient
#: near eps into a parameter step of up to lr, and the one-at-a-time fused
#: step lies as far from the whole-batch one there as the syncs do: that
#: distance is printed beside each sync's, as the witness.
SYNC_LR = 1e-3
SYNC_LOSS_TOL = 1e-3
SYNC_PARAM_TOL = 1e-5
SYNC_GRAD_FLOOR = 1e-6
SYNC_GRAD_TOL = {"float32": 1e-5, "bfloat16": 4 * 2.0 ** -7}
SYNC_NORM_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
SYNCS = (("mare_tree depth 1", "mare_tree", 1, False, DP_MESH),
         ("mare_tree depth 2", "mare_tree", 2, False, DP_MESH),
         ("mare_tree depth 3", "mare_tree", 3, False, DP_MESH),
         ("mare_tree depth 2 int8", "mare_tree", 2, True, DP_MESH),
         ("hierarchical", "hierarchical", 2, False, POD_MESH))


def host_ms(fn) -> float:
    """Host wall of ``fn()`` between two synchronizes, in ms."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (time.perf_counter() - t0) * 1e3


def mesh_of(spec):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(spec[0], spec[1])


def prefill_under(model, params, tokens, mesh=None, rules=None):
    """The model's prefill of ``tokens`` (no gradients), under the mesh's
    rules when a mesh is given; returns (logits, caches)."""
    import torch
    from repro_torch.sharding import use_rules
    with torch.no_grad(), use_rules(rules, mesh):
        return model.prefill(params, {"tokens": tokens}, tokens.shape[1])


def cp_prefill_path(seed: int, cfg=None, batch: int = BATCH,
                    prompt: int = PROMPT, mesh_spec=CP_MESH) -> dict:
    """10a: hymba's prefill with ``ssm_cp`` under ``make_rules`` on a
    (data, model) mesh: each layer's SSM block runs context-parallel,
    two launches of the scan kernel's chunked route a shard (the second
    from the carried state), 2 x shards x layers in all; the SSM states
    it returns are zero, as the reference's.  Its logits are held to the
    plain prefill's as the scan routes are (``hold_to_f32``: on an f32
    copy within SSM_ROUTE_TOL_FRAC of the largest |logit|, and in bf16 no
    farther from that f32 model than the plain bf16 prefill, plus
    LOGIT_TOL_FRAC).  The warm walls of both in turns."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding import make_rules
    t0 = time.perf_counter()
    cfg = (cfg or get_config(HYBRID_ARCH)).scaled(ssm_cp=True)
    L, name = cfg.num_layers, cfg.name
    model = build_model(cfg, device="cuda")
    params = model.init(seed)
    dev = model.device
    mesh = mesh_of(mesh_spec)
    rules = make_rules(mesh)
    cp_ssm = 2 * mesh.size * L
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(seed + 101))

    def run(m, p, cp: bool, path: str):
        route = "simt" if m.cfg.dtype == "float32" else "wgmma"
        n = cp_ssm if cp else L
        reset_launches()
        logits, caches = prefill_under(m, p, tokens, *(
            (mesh, rules) if cp else ()))
        read_launches(path, {"ssm_scan": n, "flash_attention": L}, route,
                      {"chunked": n})
        return logits, caches

    logits, caches = run(model, params, True, f"mesh: {name} cp prefill")
    if any(float(c.ssm.h.abs().max()) != 0.0 for c in caches):
        raise AssertionError("a cp prefill returned a non-zero SSM state")
    del caches
    plain, _ = run(model, params, False, f"mesh: {name} prefill")
    if not bool(torch.isfinite(logits).all()) or \
            logits.shape != (batch, prompt, cfg.vocab_size):
        raise AssertionError(f"cp prefill logits {tuple(logits.shape)} "
                             f"not finite")
    if cfg.dtype == "float32":
        cp32, plain32 = logits, plain
    else:
        m32 = build_model(cfg.scaled(dtype="float32"), device=dev)
        p32 = copy.deepcopy(params).float()
        cp32, _ = run(m32, p32, True, f"mesh: {name} cp prefill f32")
        plain32, _ = run(m32, p32, False, f"mesh: {name} prefill f32")
        del m32, p32
    scale = max_abs(plain32)
    f32_diff = max_abs_diff(cp32, plain32)
    rms = {"cp": rel_rms(logits, plain32), "plain": rel_rms(plain, plain32)}
    del cp32, plain32
    hold_to_f32("cp prefill vs plain prefill", f32_diff, scale, rms["cp"],
                rms["plain"])
    del logits, plain
    torch.cuda.empty_cache()
    (plain_ms, cp_ms), turns = in_turns(host_ms, [
        lambda: prefill_under(model, params, tokens)[0],
        lambda: prefill_under(model, params, tokens, mesh, rules)[0]])
    out = {"mesh": dict(mesh.shape), "batch": [batch, prompt],
           "ssm_scan_launches": cp_ssm, "plain_ssm_scan_launches": L,
           "f32_max_abs_diff": f32_diff, "max_abs_logit": scale,
           "bf16_rel_rms_to_f32": rms, "prefill_ms": plain_ms,
           "cp_prefill_ms": cp_ms, "ms_in_turns": turns}
    phase("mesh 10a: context-parallel SSM prefill", t0,
          f"arch={name} mesh={dict(mesh.shape)} batch={batch}x{prompt} "
          f"ssm_scan launches cp={cp_ssm} (chunked) plain={L}; f32 "
          f"max_abs_diff={f32_diff} frac={f32_diff / scale:.3e} "
          f"tol_frac={SSM_ROUTE_TOL_FRAC}; bf16 to f32 rel_rms cp="
          f"{rms['cp']:.5f} plain={rms['plain']:.5f} (tol "
          f"+{LOGIT_TOL_FRAC}); warm prefill_ms plain={plain_ms:.3f} "
          f"cp={cp_ms:.3f} (in turns {[round(t, 3) for t in turns]})")
    return out


def ep_prefill_path(seed: int, cfg=None, batch: int = BATCH,
                    prompt: int = PROMPT, mesh_spec=EP_MESH,
                    tol_frac: float = LOGIT_TOL_FRAC) -> dict:
    """10b: granite's prefill under ``make_rules`` on a (data, model)
    mesh, each MoE layer on its expert-parallel path (the token copies
    packed by owner and exchanged over ``model``; no dispatch kernel
    launch), in both layouts: at capacity factor EP_NO_DROP_CF no copy
    drops and the logits lie within ``tol_frac`` of the largest |logit|
    of the dense path's (the dispatch kernel's); at the config's own
    capacity factor the drops and the walls, in turns with the dense
    prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.sharding import make_rules
    t0 = time.perf_counter()
    cfg = cfg or get_config(MOE_ARCH)
    L, name = cfg.num_layers, cfg.name
    route = "simt" if cfg.dtype == "float32" else "wgmma"
    model = build_model(cfg, device="cuda")
    params = model.init(seed)
    dev = model.device
    mesh = mesh_of(mesh_spec)
    rules = make_rules(mesh)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(seed + 202))
    reset_launches()
    dense, _ = prefill_under(model, params, tokens)
    read_launches(f"mesh: {name} dense prefill",
                  {"moe_dispatch": L, "flash_attention": L}, route)
    scale = max_abs(dense)
    out = {"mesh": dict(mesh.shape), "batch": [batch, prompt],
           "experts_per_shard": cfg.num_experts // mesh.shape["model"],
           "runs": {}}
    for cf in (EP_NO_DROP_CF, cfg.capacity_factor):
        for mode in MOE_MODES:
            m = build_model(cfg.scaled(capacity_factor=cf, moe_mode=mode),
                            device=dev)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with moe_lib.collect_stats() as stats:
                logits, _ = prefill_under(m, params, tokens, mesh, rules)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
            read_launches(f"mesh: {name} ep prefill {mode} cf {cf}",
                          {"flash_attention": L}, route)
            if len(stats) != L:
                raise AssertionError(f"{len(stats)} MoE "
                                     f"layers, expected {L}")
            dropped = sum(float(st.dropped) for st in stats)
            diff = max_abs_diff(logits, dense)
            run = {"dropped": dropped, "max_abs_diff_to_dense": diff,
                   "prefill_ms": wall,
                   "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
            del logits
            if cf == EP_NO_DROP_CF and not (dropped == 0.0 and
                                            diff <= tol_frac * scale):
                raise AssertionError(f"{mode} at capacity {cf}: dropped "
                                     f"{dropped}, logits {diff} from the "
                                     f"dense path's (> {tol_frac} x "
                                     f"{scale})")
            if cf != EP_NO_DROP_CF:
                (dense_ms, ep_ms), turns = in_turns(host_ms, [
                    lambda: prefill_under(model, params, tokens)[0],
                    lambda: prefill_under(m, params, tokens, mesh,
                                          rules)[0]])
                run.update(warm_prefill_ms=ep_ms, dense_prefill_ms=dense_ms,
                           ms_in_turns=turns)
            out["runs"][f"{mode} cf {cf}"] = run
            torch.cuda.empty_cache()
    phase("mesh 10b: expert-parallel MoE prefill", t0,
          f"arch={name} mesh={dict(mesh.shape)} batch={batch}x{prompt} "
          f"max_abs_logit={scale} tol_frac={tol_frac} "
          f"runs={json.dumps(out['runs'])}")
    return out


def sync_state(run_state, params_snapshot, named, residual):
    """The initial train state again: the snapshot's values copied into
    the model's parameters (a step updates them in place), fresh AdamW
    moments, the given residual."""
    import torch
    with torch.no_grad():
        for k, v in named.items():
            v.copy_(params_snapshot[k])
    return run_state._replace(residual=residual)


def grads_handed(opt, sink: dict):
    """``opt`` whose update first keeps the (clipped) gradients it is
    given in ``sink``, by dotted name."""
    from repro_torch.optim import Optimizer

    def update(grads, state, params, lr):
        sink.clear()
        sink.update(grads)
        return opt.update(grads, state, params, lr)

    return Optimizer(init=opt.init, update=update)


def plain_sync_grads(model, params, batch, shards: int, codec: bool,
                     clip_norm: float) -> tuple:
    """The plain version of a gradient sync over ``shards`` blocks of the
    batch's rows: each block's gradients (``backward()`` of the model's
    loss on its rows), through the int8 codec from a zero residual with
    ``codec``, added in f32 in block order and divided by ``shards``;
    returns (the gradients clipped to ``clip_norm``, their pre-clip
    norm)."""
    import torch
    from repro_torch.optim import clip_by_global_norm, named_tree
    from repro_torch.optim.compression import error_feedback_compress
    named = named_tree(params)
    rows = next(iter(batch.values())).shape[0] // shards
    acc = None
    for s in range(shards):
        part = {k: v[s * rows:(s + 1) * rows] for k, v in batch.items()}
        for p in named.values():
            p.grad = None
        model.loss(params, part)[0].backward()
        g = {k: (p.grad if p.grad is not None else torch.zeros_like(p)
                 ).float() for k, p in named.items()}
        for p in named.values():
            p.grad = None
        if codec:
            _, g, _ = error_feedback_compress(g, {
                k: v.new_zeros(()).expand(v.shape) for k, v in g.items()})
        acc = g if acc is None else {k: acc[k] + g[k] for k in acc}
        del g
    clipped, norm = clip_by_global_norm(
        {k: v / shards for k, v in acc.items()}, clip_norm)
    return clipped, float(norm)


def grad_diff(grads: dict, ref: dict) -> dict:
    """The leaf whose max |g - ref| / max |ref| is the largest share of its
    tolerance (SYNC_GRAD_TOL of the coarser dtype of the two): that
    relative difference, the tolerance and the leaf."""
    import torch
    out = {"grad_rel_diff": 0.0, "grad_tol": SYNC_GRAD_TOL["float32"],
           "grad_leaf": None}
    for k, r in ref.items():
        g = grads[k]
        tol = SYNC_GRAD_TOL["bfloat16" if torch.bfloat16 in (g.dtype,
                                                              r.dtype)
                            else "float32"]
        d = float((g.float() - r.float()).abs().max())
        m = float(r.float().abs().max())
        rel = d / m if m else d
        if rel / tol > out["grad_rel_diff"] / out["grad_tol"] or \
                out["grad_leaf"] is None:
            out = {"grad_rel_diff": rel, "grad_tol": tol, "grad_leaf": k}
    return out


def param_diffs(named: dict, ref: dict, floor: Optional[dict] = None
                ) -> dict:
    """The largest |parameter - ref| over every element and, with
    ``floor``, over the elements whose fused gradient is at or above
    SYNC_GRAD_FLOOR and over those below it, and how many lie below."""
    out = {"all": 0.0}
    if floor is not None:
        out.update(above_floor=0.0, below_floor=0.0, elements_below_floor=0)
    for k, v in named.items():
        diff = (v.detach().float() - ref[k].float()).abs()
        out["all"] = max(out["all"], float(diff.max()))
        if floor is None:
            continue
        low = floor[k]
        for key, part in (("above_floor", diff[~low]),
                          ("below_floor", diff[low])):
            if part.numel():
                out[key] = max(out[key], float(part.max()))
        out["elements_below_floor"] += int(low.sum())
    return out


def sync_steps(label: str, model, optimizer, state, batch,
               param_check: bool) -> dict:
    """One AdamW step (constant lr SYNC_LR) of the fused sync and of each
    of SYNCS from the same state and batch, each with its flash launches
    (forward, remat's recompute and backward, once a shard a layer), its
    wall and peak allocated bytes, held as the note on SYNC_LR says; with
    ``param_check`` also the fused step over the batch's sequences one at
    a time, and the parameters."""
    import torch
    from repro_torch.optim import named_tree
    from repro_torch.optim.compression import init_residual
    from repro_torch.optim.schedule import constant
    from repro_torch.sharding import data_only_rules
    from repro_torch.train import StepConfig, make_train_step
    cfg = model.cfg
    L = cfg.num_layers
    per = 2 if cfg.remat else 1
    route = "simt" if cfg.dtype == "float32" else "wgmma"
    clip = StepConfig().clip_norm
    rows = next(iter(batch.values())).shape[0]
    named = named_tree(state.params)
    snapshot = {k: v.detach().clone() for k, v in named.items()}
    handed: dict = {}
    # one untimed fused step first: the first step after the set-up pays
    # the libraries' start-up (10 s for Llama-3.2-1B on an H100)
    make_train_step(model, optimizer, constant(SYNC_LR), StepConfig())(
        sync_state(state, snapshot, named, ()), batch)
    runs = (("fused", "fused", 2, False, None, 1),)
    if param_check:
        runs += (("fused one at a time", "fused", 2, False, None, rows),)
    runs += tuple(s + (1,) for s in SYNCS)
    results, refs = {}, {}
    for name, sync, depth, comp, spec, micro in runs:
        mesh = mesh_of(spec) if spec else None
        shards = mesh.size if mesh else micro
        step = make_train_step(model, grads_handed(optimizer, handed),
                               constant(SYNC_LR),
                               StepConfig(grad_sync=sync, tree_depth=depth,
                                          compression=comp, microbatch=micro),
                               mesh=mesh, rules=data_only_rules(mesh)
                               if mesh else None)
        st = sync_state(state, snapshot, named,
                        init_residual(state.params) if comp else ())
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, metrics = step(st, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        read_launches(f"mesh: {label} {name}",
                      {"flash_attention": per * L * shards,
                       "flash_attention_bwd": L * shards}, route)
        res = {"loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]), "step_ms": wall,
               "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
               "mesh": dict(mesh.shape) if mesh else None}
        grads = dict(handed)
        handed.clear()
        if name == "fused":
            refs["fused"] = (grads, res["grad_norm"])
            if param_check:
                refs["floor"] = {k: g.abs() < SYNC_GRAD_FLOOR
                                 for k, g in grads.items()}
                refs["fused params"] = {k: v.detach().clone()
                                        for k, v in named.items()}
            results[name] = res
            del new, metrics, st, step, grads
            continue
        res["loss_diff"] = abs(res["loss"] - results["fused"]["loss"])
        if param_check:
            res["params_vs_fused"] = param_diffs(named, refs["fused params"],
                                                 refs["floor"])
        ref_name = "plain int8" if comp else "fused"
        if comp:
            # the initial parameters again, for the plain version
            sync_state(state, snapshot, named, ())
            ref_grads, ref_norm = plain_sync_grads(model, state.params, batch,
                                                   shards, True, clip)
        else:
            ref_grads, ref_norm = refs["fused"]
        res["grads_held_to"] = ref_name
        res["grad_norm_rel_diff"] = abs(res["grad_norm"] - ref_norm) / ref_norm
        res.update(grad_diff(grads, ref_grads))
        res["grad_norm_tol"] = SYNC_NORM_TOL[
            "bfloat16" if any(torch.bfloat16 in (g.dtype, ref_grads[k].dtype)
                              for k, g in grads.items()) else "float32"]
        del grads, ref_grads
        failed = [what for what, bad in (
            ("loss", not res["loss_diff"] <= SYNC_LOSS_TOL),
            ("gradient norm",
             not res["grad_norm_rel_diff"] <= res["grad_norm_tol"]),
            ("gradients", not res["grad_rel_diff"] <= res["grad_tol"])) if bad]
        if param_check:
            if micro > 1:
                refs["one at a time params"] = {
                    k: v.detach().clone() for k, v in named.items()}
            elif not comp:
                res["params_vs_one_at_a_time"] = param_diffs(
                    named, refs["one at a time params"])["all"]
                if not (res["params_vs_fused"]["above_floor"] <=
                        SYNC_PARAM_TOL and res["params_vs_one_at_a_time"]
                        <= SYNC_PARAM_TOL):
                    failed.append("parameters")
        if comp and not all(bool(torch.isfinite(r).all()) for r in
                            new.residual.values()):
            failed.append("residual not finite")
        if failed:
            raise AssertionError(f"{label} {name}: {failed} against the "
                                 f"{ref_name} step: {res}")
        results[name] = res
        del new, metrics, st, step
    with torch.no_grad():
        for k, v in named.items():
            v.copy_(snapshot[k])
    del snapshot, refs
    torch.cuda.empty_cache()
    return results


def sync_path(seed: int, tmp: str, arch: str = ARCH,
              smoke: bool = False, batch: int = BATCH,
              seq: int = PROMPT) -> dict:
    """10c: the gradient syncs on Llama-3.2-1B, through
    ``launch/train.py``'s setup (full width and depth, bf16, batch BATCH x
    PROMPT, one sequence a shard on DP_MESH and POD_MESH), then on its
    TRAIN_GRAD_CHECK_LAYERS-layer f32 copy at full width, whose
    parameters are held too (:func:`sync_steps`)."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import init_train_state
    t0 = time.perf_counter()
    argv = ["--arch", arch, "--steps", "1", "--batch", str(batch), "--seq",
            str(seq), "--ckpt-dir", tmp, "--seed", str(seed), "--device",
            "cuda"] + (["--smoke"] if smoke else [])
    run = train.setup(train.parser().parse_args(argv))
    b = run.batch_fn(0)
    full = sync_steps(arch, run.model, run.optimizer, run.state, b,
                      param_check=run.cfg.dtype == "float32")
    cfg = run.cfg.scaled(num_layers=TRAIN_GRAD_CHECK_LAYERS,
                         dtype="float32")
    del run, b
    torch.cuda.empty_cache()
    model = build_model(cfg, device="cuda")
    opt = adamw()
    state = init_train_state(model, opt, seed)
    b = train.make_batch_fn(cfg, batch, seq, seed, model.device)(0)
    f32 = sync_steps(f"{arch} f32 {cfg.num_layers} layers", model, opt,
                     state, b, param_check=True)
    del model, state, b
    torch.cuda.empty_cache()
    phase("mesh 10c: gradient syncs", t0,
          f"arch={arch} batch={batch}x{seq} lr={SYNC_LR} "
          f"loss_tol={SYNC_LOSS_TOL} grad_tol={SYNC_GRAD_TOL} "
          f"grad_norm_tol={SYNC_NORM_TOL} param_tol={SYNC_PARAM_TOL} (vs "
          f"the fused step at gradients >= {SYNC_GRAD_FLOOR}, vs the "
          f"one-at-a-time fused step everywhere) bf16={json.dumps(full)} "
          f"f32_copy={json.dumps(f32)}")
    return {"bf16": full, "f32_copy": f32}


def elastic_path(seed: int, tmp: str) -> dict:
    """10d: slice 7's step-TRAIN_SAVE_AT checkpoint restored through
    ``checkpoint.rescale`` into a fresh state onto ELASTIC_MESH with
    ``make_rules`` and the model's logical axes: every parameter equal to
    the saved array bit for bit, every sharding dividing its leaf."""
    import torch
    from repro_torch.checkpoint import CheckpointManager, rescale
    from repro_torch.launch import train
    from repro_torch.optim import named_tree
    from repro_torch.sharding import make_rules
    t0 = time.perf_counter()
    args = train.parser().parse_args(train_args(tmp, seed + 2))
    fresh = train.setup(args)
    manager = CheckpointManager(tmp, keep=1)
    if manager.latest_step() != TRAIN_SAVE_AT:
        raise AssertionError(f"checkpoints {sorted(manager.latest_steps())}")
    mesh = mesh_of(ELASTIC_MESH)
    t1 = time.perf_counter()
    state, shardings = rescale(manager, fresh.state, mesh, make_rules(mesh),
                               logical_axes=fresh.model.logical_axes(),
                               step=TRAIN_SAVE_AT)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    named = named_tree(state.params)
    path = os.path.join(tmp, f"step_{TRAIN_SAVE_AT:08d}", "arrays.npz")
    differ, split = [], 0
    with np.load(path) as saved:
        for key in sorted({"/".join(p for p in k.split(".")
                                    if not p.isdigit()) for k in named}):
            arr = saved["params__" + key.replace("/", "__")]
            for k, v in named.items():
                parts = k.split(".")
                if "/".join(p for p in parts if not p.isdigit()) != key:
                    continue
                idx = tuple(int(p) for p in parts if p.isdigit())
                want = torch.from_numpy(arr[idx] if idx else arr).to(
                    v.device, v.dtype)
                if not torch.equal(want, v.detach()):
                    differ.append(k)
                shardings[k].check(v.shape)
                split += any(e is not None for e in shardings[k].spec)
    if differ or int(state.step) != TRAIN_SAVE_AT or \
            set(shardings) != set(named):
        raise AssertionError(f"elastic restore: {len(differ)} parameters "
                             f"differ from the checkpoint ({differ[:5]}), "
                             f"step {int(state.step)}")
    out = {"mesh": dict(mesh.shape), "restore_s": restore_s,
           "parameters": len(named), "split_by_the_rules": split}
    phase("mesh 10d: elastic restore", t0,
          f"step {TRAIN_SAVE_AT} checkpoint onto mesh {dict(mesh.shape)} "
          f"in {restore_s:.3f} s: {len(named)} parameters bit-equal to the "
          f"saved arrays, {split} split by make_rules, every sharding "
          f"dividing its leaf")
    del fresh, state
    return out


def mesh_slice(seed: int, train_tmp: str) -> None:
    """Slice 10: 10a-10d on the shards of one card; prints a ``[mesh]``
    JSON line."""
    import torch
    out = {"cp_prefill": cp_prefill_path(seed)}
    torch.cuda.empty_cache()
    out["ep_prefill"] = ep_prefill_path(seed)
    torch.cuda.empty_cache()
    out["grad_sync"] = sync_path(seed, train_tmp)
    torch.cuda.empty_cache()
    out["elastic"] = elastic_path(seed, train_tmp)
    torch.cuda.empty_cache()
    print("[mesh] " + json.dumps(out), flush=True)


# ---------------------------------------------------------------------------
# slice 11: the dry run, and its count held to real steps on the card
# ---------------------------------------------------------------------------

#: Slice 11a's cells on the production mesh (16 x 16).
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("hymba-1.5b", "prefill_32k"),
                ("granite-moe-1b-a400m", "decode_32k"))
#: ``argument_bytes`` against the bytes the caching allocator was asked
#: for at the step's start.
DRYRUN_ARG_TOL = 0.01
#: The k-mer action of slice 11c runs on a genome of this many bases.
DRYRUN_KMER_BASES = 4_000_000
#: The warm step's ms of slices 7 and 9's training runs, by arch.
WARM_STEP_MS: dict = {}


def dryrun_cells() -> dict:
    """11a: the dry run of DRYRUN_CELLS on meta, on this machine's host."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun_lib import dry_run_cell
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    out = {}
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        r = dry_run_cell(get_config(arch), get_shape(shape), mesh)
        cell = {k: r[k] for k in ("flops", "bytes", "compute_s", "memory_s",
                                  "collective_s", "lower_s", "ssm_cp",
                                  "moe_mode", "optimizer")}
        cell["peak_bytes"] = r["memory"]["peak_bytes"]
        cell["argument_bytes"] = r["memory"]["argument_bytes"]
        cell["kernel_calls"] = {k: v["calls"] for k, v in
                                r["kernels"].items()}
        if not r["flops"] > 0 or not r["bytes"] > 0:
            raise AssertionError(f"dry run {arch} x {shape}: {cell}")
        out[f"{arch} x {shape}"] = cell
        phase(f"dry run {arch} x {shape}", t0, json.dumps(cell))
    if not out["hymba-1.5b x prefill_32k"]["ssm_cp"] or \
            out["granite-moe-1b-a400m x decode_32k"]["moe_mode"] \
            != "token_gather" or any(
                out[c]["collective_s"] is None for c in
                ("hymba-1.5b x prefill_32k",
                 "granite-moe-1b-a400m x decode_32k")):
        raise AssertionError(f"dry run policies: {out}")
    return out


def granite_prefill_step(device: str, seed: int):
    """(the granite prefill at the serving shape as a function of no
    arguments, what it is handed) on ``device``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(MOE_ARCH)
    model = build_model(cfg, device=device)
    params = model.init(seed)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)).to(device)

    def prefill():
        with torch.no_grad():
            return model.prefill(params, {"tokens": tokens}, PROMPT + GEN)
    return prefill, (params, {"tokens": tokens})


def train_step_of(arch_args: list, device: str):
    """(one training step of ``launch/train.py``'s setup as a function of
    no arguments, what it is handed) on ``device``."""
    from repro_torch.launch import train
    args = train.parser().parse_args(arch_args)
    args.device = device
    run = train.setup(args)
    batch = run.batch_fn(0)
    return (lambda: run.train_step(run.state, batch)), (run.state, batch)


def counted_twins(name: str, build, expect: dict, arch: Optional[str],
                  **read_kw) -> dict:
    """11b: the step ``build(device)`` makes, run once on the card under
    the work counter (every launch counter read around it) and once on
    meta; flops, bytes and every kernel's reported operations must be
    equal, and ``argument_bytes`` within DRYRUN_ARG_TOL of the bytes the
    caching allocator was asked for at the step's start, beyond those
    before the step was built (what earlier slices hold is not the
    step's; ``memory_allocated()``, printed beside, adds the allocator's
    rounding of each block, 1.4% at hymba's widths)."""
    import gc
    import torch
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.dryrun_lib import argument_bytes
    t0 = time.perf_counter()
    gc.collect()
    before = torch.cuda.memory_allocated()
    requested0 = torch.cuda.memory_stats().get(
        "requested_bytes.all.current", 0)
    fn, args = build("cuda")
    torch.cuda.synchronize()
    dev = torch.device("cuda", torch.cuda.current_device())
    arg_bytes = argument_bytes(*args, device=dev)
    allocated = torch.cuda.memory_allocated() - before
    requested = torch.cuda.memory_stats()[
        "requested_bytes.all.current"] - requested0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with hlo_cost.Counter() as card:
        fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches(f"dry run twin: {name}", expect, **read_kw)
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    mfn, margs = build("meta")
    meta_arg_bytes = argument_bytes(*margs)
    with hlo_cost.Counter() as meta:
        mfn()
    got, want = card.result(), meta.result()
    calls = {k: v["calls"] for k, v in got["kernels"].items()}
    out = {"flops": got["flops"], "bytes": got["bytes"],
           "meta_flops": want["flops"], "meta_bytes": want["bytes"],
           "matmul_flops": got["matmul_flops"], "ops": got["ops"],
           "kernel_ops": {k: v["ops"] for k, v in got["kernels"].items()},
           "kernel_calls": calls,
           "argument_bytes": arg_bytes, "meta_argument_bytes":
           meta_arg_bytes, "requested_at_start": requested,
           "allocated_at_start": allocated,
           "allocated_before_building": before,
           "meta_peak_bytes": meta_arg_bytes + want["peak_bytes"],
           "max_memory_allocated": peak}
    out["peak_ratio"] = out["meta_peak_bytes"] / peak
    if arch in WARM_STEP_MS:
        out["warm_step_ms"] = WARM_STEP_MS[arch]
        out["peak_share"] = got["flops"] / (
            WARM_STEP_MS[arch] / 1e3 * 989e12)
    phase(f"dry run twin: {name}", t0, json.dumps(out))
    diff = {op: (row, want_row) for op, row in card.by_op.items()
            for want_row in [meta.by_op.get(op)] if row != want_row}
    diff.update({op: (None, row) for op, row in meta.by_op.items()
                 if op not in card.by_op})
    if (got["flops"], got["bytes"]) != (want["flops"], want["bytes"]) or \
            got["kernels"] != want["kernels"]:
        raise AssertionError(f"{name}: the card's count {got['flops']} "
                             f"flops, {got['bytes']} bytes, kernels "
                             f"{got['kernels']}; meta's {want['flops']}, "
                             f"{want['bytes']}, {want['kernels']}; ops "
                             f"that differ (calls, flops, bytes): {diff}")
    if calls != {k: v for k, v in launches.items() if v}:
        raise AssertionError(f"{name}: kernel reports {calls}, launches "
                             f"{launches}")
    if abs(arg_bytes - requested) > DRYRUN_ARG_TOL * requested or \
            arg_bytes != meta_arg_bytes:
        raise AssertionError(f"{name}: argument_bytes {arg_bytes} (meta "
                             f"{meta_arg_bytes}), requested at the step's "
                             f"start {requested} (allocated {allocated})")
    return out


def planner_cost(name: str, action, kernel: str, expect: int,
                 **read_kw) -> dict:
    """11c: ``action()`` (a MaRe chain) collected with tracing on, from a
    fresh plan cache: the program's ``cost``, and its counter's reports of
    ``kernel`` against the launches the action made."""
    from repro_torch.core import planner
    from repro_torch.obs import tracing
    t0 = time.perf_counter()
    planner.DEFAULT_CACHE.clear()
    chain = action()
    reset_launches()
    with tracing():
        chain.collect()
    launches = read_launches(f"dry run cost: {name}", {kernel: expect},
                             **read_kw)
    progs = [p for p in planner.DEFAULT_CACHE._programs.values()
             if p.cost is not None]
    calls = sum(p.work["kernels"].get(kernel, {}).get("calls", 0)
                for p in progs)
    out = {"programs": len(progs), "cost": [p.cost for p in progs],
           "kernel_calls": calls, "launches": launches[kernel]}
    phase(f"dry run cost: {name}", t0, json.dumps(out))
    if not progs or calls != launches[kernel] or not all(
            p.cost["flops"] > 0 and p.cost["bytes"] > 0 for p in progs):
        raise AssertionError(f"{name}: {out}")
    return out


def dryrun_slice(seed: int, tmp: str) -> None:
    """Slice 11: 11a the dry run of three cells on meta; 11b the card's
    counted Llama and hymba training steps and granite prefill against
    their meta twins; 11c the planner's count of the k-mer and VS
    actions; prints a ``[dryrun]`` JSON line."""
    import torch
    out = {"cells": dryrun_cells()}
    L = 16
    llama_shape = flash_shape(BATCH, 32, 8, PROMPT, PROMPT, True, None)
    out["llama3.2-1b train step"] = counted_twins(
        "llama3.2-1b train step",
        lambda dev: train_step_of(train_args(tmp, seed, 1), dev),
        {"flash_attention": 2 * L, "flash_attention_bwd": L}, ARCH,
        flash_shapes={llama_shape: 2 * L}, bwd_shapes={llama_shape: L})
    torch.cuda.empty_cache()
    H = 32
    out["hymba-1.5b train step"] = counted_twins(
        "hymba-1.5b train step",
        lambda dev: train_step_of(hymba_train_args(tmp, seed, 1), dev),
        {"ssm_scan": 2 * H, "ssm_scan_bwd": H, "flash_attention": 2 * H,
         "flash_attention_bwd": H}, HYBRID_ARCH,
        ssm_routes={"chunked": 2 * H})
    torch.cuda.empty_cache()
    G = 24
    out["granite prefill"] = counted_twins(
        "granite-moe-1b-a400m prefill",
        lambda dev: granite_prefill_step(dev, seed),
        {"moe_dispatch": G, "flash_attention": G}, None)
    torch.cuda.empty_cache()
    genome = os.path.join(tmp, "dryrun.fa")
    write_fasta(genome, make_genome(DRYRUN_KMER_BASES, seed))

    def kmer():
        from repro_torch.core import MaRe
        from repro_torch.io import fasta_source
        return kmer_query(MaRe.from_source(fasta_source(genome),
                                           num_shards=NUM_SHARDS))
    out["k-mer cost"] = planner_cost("k-mer", kmer, "segment_sum",
                                     2 * NUM_SHARDS)
    lib = make_library(VS_MOLECULES, seed)
    out["VS cost"] = planner_cost(
        "VS", lambda: virtual_screening(lib, num_shards=NUM_SHARDS),
        "topk_reduce", topk_combines(NUM_SHARDS, VS_DEPTH))
    torch.cuda.empty_cache()
    print("[dryrun] " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    from repro_torch.kernels.exchange import kernel as xmod
    libs = [mod.LIBRARY for mod in kernel_modules().values()] + [
        xmod.LIBRARY]
    paths = build.build_all(libs, verbose=True)
    phase("build kernels", t0, " ".join(
        f"{lib.name}_nvcc_s={build.BUILD_SECONDS.get(lib.name, 0.0):.3f}"
        for lib in libs) + f" libs={[str(p) for p in paths]}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        record, genome = kmer_slice(tmp, args.seed)
        records = [record, exchange_slice(genome["fasta"], args.seed)]
        runtime_slice(genome, tmp)
        stream_service_slice(genome, tmp)
        del genome
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    records += lm_slice(args.seed)
    torch.cuda.empty_cache()
    vlm_slice(args.seed)
    torch.cuda.empty_cache()
    audio_slice(args.seed)
    torch.cuda.empty_cache()
    records.append(moe_slice(args.seed))
    torch.cuda.empty_cache()
    records.append(vs_slice(args.seed))
    torch.cuda.empty_cache()
    snp_slice(torch.device("cuda"))
    torch.cuda.empty_cache()
    records.append(hybrid_slice(args.seed))
    torch.cuda.empty_cache()
    records += jamba_slice(args.seed)
    torch.cuda.empty_cache()
    train_tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        records.append(train_slice(args.seed, train_tmp))
        torch.cuda.empty_cache()
        records.append(hymba_train_slice(args.seed))
        torch.cuda.empty_cache()
        xlstm_slice(args.seed)
        torch.cuda.empty_cache()
        mesh_slice(args.seed, train_tmp)
        torch.cuda.empty_cache()
        dryrun_slice(args.seed, train_tmp)
    finally:
        shutil.rmtree(train_tmp, ignore_errors=True)
    for rec in records:
        if rec["name"] == "flash_attention":
            served_shape_launches(rec)
        rec["launches_by_path"] = {
            path: got[rec["name"]] for path, got in PATH_LAUNCHES.items()
            if got.get(rec["name"])}
        by_route = {"flash_attention": FLASH_ROUTES,
                    "flash_attention_bwd": FLASH_BWD_ROUTES,
                    "ssm_scan": SSM_ROUTES,
                    "ssm_scan_dt": SSM_DT_ROUTES,
                    "mamba_conv": CONV_ROUTES,
                    "ssm_scan_bwd": SSM_BWD_ROUTES,
                    "segment_sum": SEGMENT_ROUTES,
                    "moe_dispatch": DISPATCH_ROUTES,
                    "topk_reduce": TOPK_ROUTES,
                    "exchange": EXCHANGE_ROUTES}.get(rec["name"])
        if by_route is not None:
            rec["launches_by_path"] = {
                path: by_route[path] for path in rec["launches_by_path"]}

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    phase("nvidia-smi", t0)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
