"""Serving entry point of the port: two modes behind one entry point.

* ``--service`` — the **multi-tenant query-service loop**: builds a
  shared dataset of random reads, starts a
  :class:`repro_torch.serve.QueryService`, runs N tenant sessions issuing
  rounds of k-mer aggregation queries (sum, max, min in turn, all tenants
  together) against the persisted shared prefix, and prints QPS, p50 /
  p99 latency, batch occupancy, per-tenant reports and the final cache
  picture:

      PYTHONPATH=src python -m repro_torch.launch.serve --service \\
          --tenants 4 --rounds 5 --device cpu

* ``--model-smoke`` — prefills a batch of random prompts and
  greedy-decodes N tokens, printing the reference's three lines (prefill
  ms, decode ms/token, generated tokens):

      PYTHONPATH=src python -m repro_torch.launch.serve --model-smoke \\
          --arch llama3.2-1b --smoke --device cpu

Both run on ``cuda`` unless ``--device`` names another device; without a
GPU the default raises.  Weights and reads are random, drawn from
``--seed``.  Where the reference shards over its device mesh, the
service takes ``--num-shards`` logical shards on the one device.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs


@dataclasses.dataclass
class SmokeRun:
    """What one ``--model-smoke`` run produced, for callers that check it."""
    model: Any                  # repro_torch.models.Model
    params: Any                 # the LM (EncDec for audio) module
    batch: Dict[str, torch.Tensor]  # the prefill's: tokens (the prompt,
    #                             [B, prompt_len] int64), and frames
    #                             (audio) or patch_embeds (vlm)
    logits: torch.Tensor        # prefill logits [B, P + prompt_len, V]
    #                             (P = vlm's patches, else 0)
    cache: Any                  # after the last decode step: a StackedKV
    #                             (dense, MoE, vlm), a list of LayerCache
    #                             (hybrid) or of per-layer dicts (audio)
    generated: np.ndarray       # [B, gen] greedy tokens
    prefill_s: float
    decode_s_per_token: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_smoke(args: argparse.Namespace,
                params: Optional[Any] = None) -> SmokeRun:
    """Prefill ``args.batch`` random prompts of ``args.prompt_len`` tokens,
    then greedy-decode ``args.gen`` tokens.  The audio family's batch
    holds random encoder frames, vlm's random patch embeddings, drawn
    after the prompt as the reference draws them.  ``params`` (the model
    module) replaces the seeded random weights when given."""
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
        max_len = args.prompt_len + args.gen + (cfg.num_patches or 0)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)}
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(rng.normal(size=(
                args.batch, cfg.encoder_seq, cfg.d_model))).to(
                    dev, cfg.param_dtype)
        if cfg.family == "vlm" and cfg.num_patches:
            batch["patch_embeds"] = torch.from_numpy(rng.normal(size=(
                args.batch, cfg.num_patches, cfg.d_model))).to(
                    dev, cfg.param_dtype)

        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_len)
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
    return SmokeRun(model=model, params=params, batch=batch,
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


# -- one greedy request -------------------------------------------------------

@dataclasses.dataclass
class LMRequest:
    """One greedy request's answer, on the device, and its report."""
    ids: torch.Tensor           # [B, gen + 1]: the prefill's token, then
    #                             one a decode step
    logits: torch.Tensor        # [B, gen + 1, V] float32: the last prompt
    #                             position's, then each decode step's
    report: Any                 # runtime.reports.ActionReport


_REQUEST_IDS = itertools.count()


def greedy_request(model: Any, params: Any, tokens: torch.Tensor, gen: int,
                   max_len: Optional[int] = None) -> LMRequest:
    """Prefill ``tokens`` [B, S] and greedy-decode ``gen`` steps through
    the cache, keeping every step's logits in float32 on the device.

    The report's phases: ``dispatch`` (host time to enqueue the request,
    the host reads inside it included: the MoE's expert sizes, the wait
    for the prefill) and ``device_wait`` (waiting for the last decode
    step's last launch) split its ``wall_s``, as the executor's do an
    action's; ``prefill`` (the prefill, up to its last launch's end) and
    ``decode`` (the ``gen`` decode steps' enqueue) split it the other
    way.  At the end the copies an expert-parallel MoE dropped reach the
    ``moe.dropped`` counter (``moe.flush_dropped``)."""
    from repro_torch.models.moe import flush_dropped
    from repro_torch.runtime.executor import _device_wait
    from repro_torch.runtime.reports import ActionReport

    dev = tokens.device
    b, s = tokens.shape
    phases: Dict[str, float] = {}
    t0 = time.monotonic()
    with torch.no_grad():
        with obs.timed("dispatch", phases):
            logits, cache = model.prefill(params, {"tokens": tokens},
                                          max_len or s + gen)
            rows = [logits[:, -1].float()]
            ids = [torch.argmax(rows[-1], dim=-1)]
            _device_wait(dev)
            t1 = time.monotonic()
            for _ in range(gen):
                lg, cache = model.decode_step(params, cache, ids[-1])
                rows.append(lg.float())
                ids.append(torch.argmax(rows[-1], dim=-1))
            t2 = time.monotonic()
        with obs.timed("device_wait", phases):
            _device_wait(dev)
    flush_dropped()
    phases["prefill"] = t1 - t0
    phases["decode"] = t2 - t1
    report = ActionReport(
        action_id=next(_REQUEST_IDS),
        plan=f"lm.prefill({b}x{s}) -> lm.decode_step x{gen}",
        total_stages=1 + gen, wall_s=time.monotonic() - t0, phases=phases,
        device=str(dev))
    return LMRequest(ids=torch.stack(ids, dim=1),
                     logits=torch.stack(rows, dim=1), report=report)


# -- the query-service loop ---------------------------------------------------

READ_LEN = 64
QUERY_OPS = ("sum", "max", "min")


def make_reads(n_reads: int, seed: int = 0) -> dict:
    """``n_reads`` random ACGT reads of ``READ_LEN`` bases as byte
    records (``data`` uint8 [n, READ_LEN], ``len`` int32)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    data = bases[rng.integers(0, 4, size=(n_reads, READ_LEN))]
    return {"data": data, "len": np.full((n_reads,), READ_LEN, np.int32)}


def _key_of(recs):
    # module-level key_by/value_by: lineage signatures and the plan cache
    # key on callable identity, so every session sharing these functions
    # shares programs AND batch keys; lambdas would defeat both
    return recs[0]


def _ones_of(recs):
    return (recs[1],)


def kmer_query(sess, shared, k: int, op: str):
    """One tenant's query: the shared ``kmer-stats`` map (persisted by
    tenant 0), then the keyed ``op`` over its 4**k keys."""
    return (sess.mare(shared)
            .map(image="kmer-stats", k=k)
            .reduce_by_key(_key_of, value_by=_ones_of, op=op,
                           num_keys=4 ** k))


@dataclasses.dataclass
class ServiceRun:
    """What one ``--service`` run produced, for callers that check it."""
    shared: Any                 # the ShardedDataset every tenant queries
    results: Dict[str, List[Tuple[str, Any]]]   # tenant -> [(op, collect())]
    reports: Dict[str, List[Any]]   # tenant -> its session's ActionReports
    latencies: List[float]      # seconds, every query of every tenant
    wall_s: float               # the rounds, all tenants together
    dispatches: int             # serve.dispatches over the rounds
    occupancy: float            # mean serve.batch_occupancy, the rounds
    cache_stats: dict           # the materialization cache's stats()
    metrics: str                # METRICS.render("serve.")
    describe: Dict[str, str]    # tenant -> its last report's describe()

    @property
    def qps(self) -> float:
        return len(self.latencies) / self.wall_s

    def latency(self, q: float) -> float:
        lat = np.sort(np.asarray(self.latencies))
        return float(lat[int(q * (len(lat) - 1))])


def service_loop(args: argparse.Namespace) -> ServiceRun:
    """The reference's service loop: ``args.tenants`` sessions over one
    shared dataset of ``args.reads`` reads; tenant 0 persists the
    ``kmer-stats`` map once; then ``args.rounds`` rounds in which every
    tenant fires the same query together (sum, max, min in turn)."""
    from repro_torch.core import MaRe
    from repro_torch.obs import METRICS
    from repro_torch.serve import QueryService, ServiceConfig

    k = args.k
    shared = MaRe(make_reads(args.reads, args.seed),
                  num_shards=args.num_shards, device=args.device).dataset
    config = ServiceConfig(
        batch_window_s=args.batch_window,
        max_queued_per_tenant=args.max_queued,
        tenant_device_budget_bytes=(args.tenant_budget_mb << 20
                                    if args.tenant_budget_mb else None))
    with QueryService(config=config) as svc:
        sessions = [svc.session(f"tenant{i}") for i in range(args.tenants)]
        # shared prefix: one tenant persists the map once; every session's
        # queries then start from the cached lineage node
        sessions[0].mare(shared).map(image="kmer-stats", k=k).persist()
        dispatched = METRICS.counter("serve.dispatches")
        occupancy = METRICS.histogram("serve.batch_occupancy")
        before = (dispatched.value, occupancy.count, occupancy.total)
        barrier = threading.Barrier(len(sessions))
        lock = threading.Lock()
        latencies: List[float] = []
        results: Dict[str, List[Tuple[str, Any]]] = {
            s.tenant: [] for s in sessions}
        errors: List[BaseException] = []

        def client(sess) -> None:
            try:
                for rnd in range(args.rounds):
                    op = QUERY_OPS[rnd % len(QUERY_OPS)]
                    barrier.wait()          # all tenants fire together
                    t0 = time.monotonic()
                    out = kmer_query(sess, shared, k, op).collect(
                        label=f"{op} query")
                    with lock:
                        latencies.append(time.monotonic() - t0)
                        results[sess.tenant].append((op, out))
            except BaseException as e:      # re-raised by the caller
                barrier.abort()
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=client, args=(s,), daemon=True)
                   for s in sessions]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        if errors:
            raise errors[0]
        stats = svc.executor.mat_cache.stats()
        run = ServiceRun(
            shared=shared, results=results,
            reports={s.tenant: list(s.reports) for s in sessions},
            latencies=latencies, wall_s=wall,
            dispatches=dispatched.value - before[0],
            occupancy=((occupancy.total - before[2])
                       / max(occupancy.count - before[1], 1)),
            cache_stats=stats, metrics=METRICS.render("serve."),
            describe={s.tenant: (s.report().describe() if s.report()
                                 else "<none>") for s in sessions})
        svc.executor.mat_cache.clear()
    return run


def service_lines(args: argparse.Namespace, run: ServiceRun) -> list:
    """The reference's result lines."""
    from repro_torch.obs import METRICS
    lines = [f"served {len(run.latencies)} actions in {run.wall_s:.2f}s "
             f"({run.qps:.1f} QPS), p50={run.latency(0.50) * 1e3:.1f}ms "
             f"p99={run.latency(0.99) * 1e3:.1f}ms, "
             f"mean batch occupancy={run.occupancy:.2f}"]
    h = METRICS.histogram("phase.queue_wait")
    if h.count:
        lines.append(f"queue_wait (live est.): p50~"
                     f"{h.percentile(50) * 1e3:.1f}ms p99~"
                     f"{h.percentile(99) * 1e3:.1f}ms over {h.count} waits")
    for tenant, desc in run.describe.items():
        lines.append(f"  {tenant}: {len(run.reports[tenant])} actions, "
                     f"last={desc}")
    lines.append(run.metrics)
    st = run.cache_stats
    lines.append(f"mat_cache: hits={st['hits']} "
                 f"shared_hits={st['shared_hits']} "
                 f"tenant_budget_violations={st['tenant_budget_violations']}")
    return lines


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--service", action="store_true",
                      help="run the multi-tenant query-service loop")
    mode.add_argument("--model-smoke", action="store_true",
                      help="batched token-decode smoke")
    # service knobs
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reads", type=int, default=2_048)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--batch-window", type=float, default=0.01)
    ap.add_argument("--max-queued", type=int, default=8)
    ap.add_argument("--tenant-budget-mb", type=int, default=None)
    ap.add_argument("--num-shards", type=int, default=8)
    # model-smoke knobs
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
        print(f"service: {args.tenants} tenants x {args.rounds} rounds, "
              f"{args.num_shards} shards on {args.device}, k={args.k} "
              f"({4 ** args.k} keys), "
              f"batch_window={args.batch_window * 1e3:.0f}ms")
        for line in service_lines(args, service_loop(args)):
            print(line)
        return 0
    if args.arch is None:
        print("--model-smoke requires --arch", file=sys.stderr)
        return 2
    for line in report_lines(args, model_smoke(args)):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
