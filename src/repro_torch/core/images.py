"""Standard container images (the "Docker Hub" of the port).

Every image registers with an :class:`~repro_torch.core.manifests.
ImageManifest`: a declarative contract carrying record schemas, a capacity
transfer function, reduce-monoid properties, and a typed command grammar.
The ``posix`` image's grammar covers the paper's Listing 1 commands
(``grep-count`` / ``awk-sum``) plus ``grep-chars`` for byte records; an
unknown command or a mistyped argument fails at *pull* time with the
image's grammar in the message.

Every image here computes exactly what the reference's image of the same
name computes, dtypes included (see :mod:`repro_torch.core.tensors`).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Optional

import torch

from repro_torch.core import tree
from repro_torch.core.container import (DEFAULT_REGISTRY, ContainerOp,
                                        Partition, Registry, container_op,
                                        make_partition)
from repro_torch.core.manifests import (ArgSpec, CommandSpec, ImageManifest,
                                        PRESERVE, SAME)
from repro_torch.core.schema import Schema, bytes_record_schema, field
from repro_torch.core.tensors import (masked_sum, stable_argsort_false_first,
                                      take_clip)
from repro_torch.kernels.topk_reduce.ops import topk_reduce


# ---------------------------------------------------------------------------
# posix: grep-count / grep-chars / awk-sum (Listing 1 micro-tools)
# ---------------------------------------------------------------------------

#: Single-leaf tuple of scalar records (any dtype) — the token stream the
#: Listing 1 integer pipeline flows through.
_SCALAR_RECORDS = Schema((field(None),))
#: One int32 count record — what the grep counters emit.
_COUNT_RECORDS = Schema((field(torch.int32),))


def _count_partition(total: torch.Tensor) -> Partition:
    return make_partition((total.to(torch.int32).reshape(1),), 1)


def _grep_count(part: Partition, codes: Any = (), **kw: Any) -> Partition:
    """``grep -o '<codes>' | wc -l``: count records whose value is in a
    set of int token codes."""
    (tokens,) = tree.leaves(part.records)
    # compare in a dtype that holds both sides exactly (jnp.isin promotes)
    wide = torch.float64 if tokens.is_floating_point() else torch.int64
    code_arr = torch.tensor(list(codes), dtype=wide, device=tokens.device)
    hit = torch.isin(tokens.to(wide), code_arr) & part.mask()
    return _count_partition(hit.sum())


def _grep_chars(part: Partition, chars: str = "", **kw: Any) -> Partition:
    """``grep -o '[<chars>]' | wc -l`` over byte records: count occurrences
    of any of the given characters inside each record's valid length."""
    data = part.records["data"]
    lens = part.records["len"]
    codes = torch.tensor([ord(c) % 256 for c in chars], dtype=torch.uint8,
                         device=data.device)
    in_len = torch.arange(data.shape[1], device=data.device)[None, :] \
        < lens[:, None]
    valid = part.mask()[:, None]
    hit = torch.isin(data, codes) & in_len & valid
    return _count_partition(hit.sum())


def _awk_sum(part: Partition, **kw: Any) -> Partition:
    """``awk '{s+=$1} END {print s}'``: sum records to a single record."""
    (vals,) = tree.leaves(part.records)
    s = masked_sum(vals, part.mask())
    return make_partition((s[None],), 1)


POSIX_MANIFEST = ImageManifest(
    commands=(
        CommandSpec(
            "grep-count",
            args=(ArgSpec("codes", type=int, required=False, variadic=True),),
            fn=_grep_count,
            input_schema=_SCALAR_RECORDS,
            output_schema=_COUNT_RECORDS,
            out_capacity=1),
        CommandSpec(
            "grep-chars",
            args=(ArgSpec("chars", type=str),),
            fn=_grep_chars,
            input_schema=bytes_record_schema(),
            output_schema=_COUNT_RECORDS,
            out_capacity=1),
        CommandSpec(
            "awk-sum",
            fn=_awk_sum,
            output_schema=SAME,
            out_capacity=1,
            monoid="sum",
            associative_commutative=True),
    ))


def _posix_entry(part: Partition, **kw: Any) -> Partition:
    raise ValueError("posix image requires a command")  # pragma: no cover


#: The paper's `ubuntu` image: POSIX text tools behind a typed grammar.
posix_ubuntu = container_op("ubuntu", manifest=POSIX_MANIFEST)(_posix_entry)
posix = container_op("posix", manifest=POSIX_MANIFEST)(_posix_entry)


# ---------------------------------------------------------------------------
# kmer-stats: FASTA byte records -> packed k-mer keys/counts (reduce_by_key
# over the 4^k k-mer key space)
# ---------------------------------------------------------------------------

_BASE_CODES = {65: 0, 67: 1, 71: 2, 84: 3}   # A C G T -> 2-bit codes

KMER_MANIFEST = ImageManifest(
    input_schema=bytes_record_schema(),
    output_schema=Schema((field(torch.int32), field(torch.int32))),
    # every record yields at most W - k + 1 windows
    out_capacity=lambda cap, env: cap * (env["W"] - env["k"] + 1),
    # packed 2-bit keys cover [0, 4**k) — downstream key tables can be
    # sized (and bounds-checked) at plan time
    key_space=lambda env: 4 ** env["k"],
    commands=(CommandSpec(
        "kmer-stats", args=(ArgSpec("k", type=int, required=False),)),),
    default_command="kmer-stats")


def _base_tables(device: torch.device):
    """byte -> 2-bit code and byte -> is-ACGT lookup tables (upper case)."""
    code = torch.zeros(256, dtype=torch.int32, device=device)
    ok = torch.zeros(256, dtype=torch.bool, device=device)
    for byte, c in _BASE_CODES.items():
        code[byte] = c
        ok[byte] = True
    return code, ok


@container_op("kmer-stats", manifest=KMER_MANIFEST, k=8)
def kmer_stats(part: Partition, k: int = 8, **kw: Any) -> Partition:
    """Emit one ``(packed k-mer key, 1)`` record per k-mer occurrence.

    Input: byte records ``{"data": uint8 [cap, W], "len": int32 [cap]}``
    (each record is one sequence line, so k-mers never span records).
    Output records: ``(codes int32, ones int32)`` with the 2-bit packing
    ``A=0 C=1 G=2 T=3`` (case-insensitive); windows containing any other
    base (N, gaps) are skipped.  ``k <= 15`` keeps codes within int32, and
    ``num_keys = 4**k`` downstream (the manifest's ``key_space``).
    """
    if not 1 <= k <= 15:
        raise ValueError(f"kmer-stats needs 1 <= k <= 15, got {k}")
    data = part.records["data"]
    lens = part.records["len"]
    cap, width = data.shape
    if k > width:
        raise ValueError(f"k={k} exceeds record width {width}")
    nw = width - k + 1
    dev = data.device
    upper = torch.where((data >= 97) & (data <= 122), data - 32, data).long()
    code_lut, ok_lut = _base_tables(dev)
    code = code_lut[upper]
    base_ok = ok_lut[upper]
    acc = torch.zeros((cap, nw), dtype=torch.int32, device=dev)
    window_ok = torch.ones((cap, nw), dtype=torch.bool, device=dev)
    for j in range(k):
        acc = acc * 4 + code[:, j:j + nw]
        window_ok = window_ok & base_ok[:, j:j + nw]
    in_len = torch.arange(nw, device=dev)[None, :] + k <= lens[:, None]
    ok = (window_ok & in_len & part.mask()[:, None]).reshape(-1)
    # compact valid k-mers to the front (partition count semantics)
    order = stable_argsort_false_first(ok)
    codes = take_clip(acc.reshape(-1), order)
    total = ok.sum().to(torch.int32)
    ones = (torch.arange(cap * nw, device=dev) < total).to(torch.int32)
    return make_partition((codes, ones), total)


# ---------------------------------------------------------------------------
# Generic combinators (used by evaluation pipelines and tests)
# ---------------------------------------------------------------------------

def _accepts_command(fn: Callable[..., Any]) -> bool:
    """Whether ``fn`` can receive the ``command`` keyword (named param or
    **kwargs)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # builtins / C callables
        return False
    for p in sig.parameters.values():
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            return True
        if p.name == "command" and p.kind in (
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.KEYWORD_ONLY):
            return True
    return False


def fn_image(name: str, fn: Callable[..., Partition], *,
             associative_commutative: bool = False,
             manifest: Optional[ImageManifest] = None,
             registry: Optional[Registry] = None,
             **defaults: Any) -> Callable[..., ContainerOp]:
    """Build + register an image from a python function at runtime
    (the `docker build` analogue for ad-hoc tools).

    The wrapped fn receives the pull-time ``command`` string whenever its
    signature can accept it (a ``command`` parameter or ``**kwargs``) —
    runtime-built images interpret their command like registered ones do.
    """
    reg = registry or DEFAULT_REGISTRY
    forward_command = _accepts_command(fn)

    @container_op(name, associative_commutative=associative_commutative,
                  manifest=manifest, registry=reg, **defaults)
    def _op(part: Partition, command: str = "", **kw: Any) -> Partition:
        if forward_command:
            return fn(part, command=command, **kw)
        return fn(part, **kw)

    return _op


TOPK_MANIFEST = ImageManifest(
    output_schema=SAME,
    out_capacity=lambda cap, env: min(int(env["k"]), cap))


@container_op("toolbox/topk", associative_commutative=True,
              manifest=TOPK_MANIFEST, k=30)
def topk_image(part: Partition, k: int = 30,
               score_field: int = 0, **kw: Any) -> Partition:
    """sdsorter analogue: keep the k best-scoring records.

    Records: tuple whose first leaf is [cap, ...]; scores are taken from
    ``records[score_field]``.  Float32 scores go through the top-k kernel
    (``kernels/topk_reduce``; its plain version on a CPU tensor); other
    dtypes through a stable descending sort.  Both give ties to the
    earlier record and, past ``count``, the earliest invalid records,
    exactly as the reference's ``lax.top_k``.  Associative + commutative.
    """
    leaves = tree.leaves(part.records)
    scores = leaves[score_field]
    if scores.ndim > 1:
        scores = scores.reshape(scores.shape[0], -1)[:, 0]
    valid = part.mask()
    if scores.is_floating_point():
        lowest = float("-inf")
    else:
        lowest = torch.iinfo(scores.dtype).min
    masked = torch.where(valid, scores,
                         torch.full((), lowest, dtype=scores.dtype,
                                    device=scores.device))
    k_eff = min(k, part.capacity)
    if scores.dtype == torch.float32:
        idx = topk_reduce(masked, k_eff, part.count)[1].long()
    else:
        idx = torch.sort(masked, descending=True, stable=True).indices[:k_eff]
    out = tree.tree_map(lambda l: l[idx], part.records)
    cnt = torch.clamp(part.count, max=k_eff)
    return make_partition(out, cnt)


CONCAT_MANIFEST = ImageManifest(output_schema=SAME, out_capacity=PRESERVE)


@container_op("toolbox/concat", associative_commutative=True,
              manifest=CONCAT_MANIFEST)
def concat_image(part: Partition, **kw: Any) -> Partition:
    """vcf-concat analogue: identity on records (concatenation is implicit
    in the tree gather)."""
    return part


SUM_MANIFEST = ImageManifest(output_schema=SAME, out_capacity=1,
                             monoid="sum")


@container_op("toolbox/sum", associative_commutative=True,
              manifest=SUM_MANIFEST)
def sum_image(part: Partition, **kw: Any) -> Partition:
    """Elementwise sum of records into a single record."""
    valid = part.mask()
    return make_partition(
        tree.tree_map(lambda l: masked_sum(l, valid)[None], part.records), 1)
