"""On the card: each CUDA kernel (segment sum, the exchange, flash
attention, RMSNorm, MoE dispatch, top-k, selective scan) against its
plain version, the k-mer, virtual-screening and SNP-calling paths on
``cuda`` against the same paths on the CPU, the launches of the LM, vlm
and encoder-decoder prefills (flash), the MoE layers (dispatch) and the
hybrid layers (selective scan), and the mesh's paths (``chip_smoke``'s
slice 10 at smoke widths: the context-parallel SSM prefill, the
expert-parallel MoE prefill, the gradient syncs against the fused step).

Every test here needs a CUDA device: it is marked ``gpu`` and skips
without one.  This file imports no JAX, so it runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs
from repro_torch.core import MaRe, collect_shard, from_host
from repro_torch.kernels.flash_attention import kernel as fmod
from repro_torch.kernels.moe_dispatch import kernel as dmod
from repro_torch.kernels.moe_dispatch import dispatch_ref, moe_dispatch
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import kernel as rmod
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.segment_reduce import kernel as kmod
from repro_torch.kernels.segment_reduce import (segment_reduce, segment_sum,
                                                segment_sum_ref)
from repro_torch.kernels.ssm_scan import kernel as smod
from repro_torch.kernels.ssm_scan import ssm_scan_fused, ssm_scan_ref
from repro_torch.kernels.topk_reduce import kernel as tmod
from repro_torch.kernels.topk_reduce import topk_reduce, topk_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CASES = {
    "random": dict(n=5000, num_keys=37),
    "single_key": dict(n=2000, num_keys=1),
    "odd_num_keys": dict(n=4097, num_keys=1000003),
    "all_masked": dict(n=1280, num_keys=16, valid_frac=0.0),
    "hot_key": dict(n=40000, num_keys=50, hot=7),
    "empty": dict(n=0, num_keys=9),
    # every record on one key: one tile past SPLIT, folded in many items
    "one_hot_key": dict(n=100000, num_keys=4 ** 12, hot=12345,
                        hot_frac=1.0, valid_frac=1.0),
    # many tiles, a tile edge every key_block keys
    "k_mer_space": dict(n=300000, num_keys=4 ** 12),
    # rows of more than three value columns: the atomic route
    "wide_rows": dict(n=3000, num_keys=1000, cols=100),
    "wide_rows_hot": dict(n=20000, num_keys=100, cols=128, hot=3),
    "rows_of_4": dict(n=20000, num_keys=3000, cols=5),
    # one value column (the float32 table of a two-column case)
    "rows_of_1": dict(n=30000, num_keys=70001, cols=2),
}


def _case(seed, n, num_keys, hot=None, valid_frac=0.8, hot_frac=0.9,
          cols=3):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-3, num_keys + 5, size=n).astype(np.int32)
    if hot is not None:
        keys[rng.random(n) < hot_frac] = hot
    valid = rng.random(n) < valid_frac
    ints = rng.integers(-50, 100, size=(n, cols)).astype(np.int32)
    floats = rng.normal(size=(n, max(cols - 1, 1))).astype(np.float32)
    floats[~valid] = np.nan            # padding may hold NaN
    return keys, valid, ints, floats


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name):
    c = dict(CASES[name])
    keys, valid, ints, floats = _case(6, **c)
    k = torch.from_numpy(keys).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    before = kmod.LAUNCHES
    by_route = dict(kmod.LAUNCHES_BY_ROUTE)
    for vals in (ints, floats):
        vals = torch.from_numpy(vals).to(cuda)
        kind = kmod.route(c["num_keys"], vals.shape[1], c["n"], cuda)
        got = segment_sum(k, vals, c["num_keys"], v)
        torch.cuda.synchronize()
        # counts, overflow and an int32 table bit for bit; a float32
        # table to the plain version in float64 (stated in segment_check)
        cs.segment_check(name, got, k, vals, v, c["num_keys"])
        if c["n"]:
            by_route[kind] += 1
    assert kmod.LAUNCHES - before == (2 if c["n"] else 0)
    assert kmod.LAUNCHES_BY_ROUTE == by_route


def test_merge_like_runs_match_plain_version(cuda):
    """A merge's input: eight buckets, each an ascending run of distinct
    keys compacted to the front, ~25% of the slots valid."""
    rng = np.random.default_rng(9)
    num_keys, cap = 4 ** 12, 1 << 18
    keys = np.zeros((8, cap), np.int32)
    valid = np.zeros((8, cap), bool)
    for b in range(8):
        m = int(cap * rng.uniform(0.2, 0.3))
        keys[b, :m] = np.sort(rng.choice(num_keys, m, replace=False))
        keys[b, m:] = rng.integers(-9, num_keys + 9, cap - m)  # stale slots
        valid[b, :m] = True
    ints = rng.integers(1, 60, size=(8 * cap, 2)).astype(np.int32)
    k = torch.from_numpy(keys.reshape(-1)).to(cuda)
    v = torch.from_numpy(valid.reshape(-1)).to(cuda)
    vals = torch.from_numpy(ints).to(cuda)
    assert kmod.route(num_keys, 2, k.numel(), cuda) == "binned"
    cs.segment_check("merge-like", segment_sum(k, vals, num_keys, v), k,
                     vals, v, num_keys)


@pytest.mark.parametrize("cols", [1, 2, 3])
def test_binned_route_writes_every_row_of_dirty_memory(cuda, cols):
    """The binned route allocates its outputs with torch.empty: after a
    large tensor full of a nonzero pattern is freed, the allocator hands
    its memory back, and every absent key must still read 0."""
    num_keys = 1000003
    junk = torch.full((num_keys * 8,), -7, dtype=torch.int32, device=cuda)
    del junk
    rng = np.random.default_rng(10)
    keys = rng.integers(0, num_keys, 5000).astype(np.int32)
    k = torch.from_numpy(keys).to(cuda)
    v = torch.ones(5000, dtype=torch.bool, device=cuda)
    vals = torch.from_numpy(
        rng.integers(1, 9, size=(5000, cols)).astype(np.int32)).to(cuda)
    assert kmod.route(num_keys, cols, 5000, cuda) == "binned"
    table, counts, overflow = segment_sum(k, vals, num_keys, v)
    absent = torch.ones(num_keys, dtype=torch.bool, device=cuda)
    absent[k.long()] = False
    assert int(absent.sum()) > num_keys - 5000
    assert not bool(counts[absent].any()) and not bool(table[absent].any())
    assert int(overflow[0]) == 0
    want = segment_sum_ref(k, vals, num_keys, v)
    assert torch.equal(table, want[0]) and torch.equal(counts, want[1])


def test_cuda_tensors_never_take_the_plain_path(cuda, monkeypatch):
    from repro_torch.kernels.segment_reduce import ops
    monkeypatch.setattr(ops, "segment_reduce_ref", None)   # would crash
    keys, valid, ints, _ = _case(7, 300, 20)
    res = segment_reduce(torch.from_numpy(keys).to(cuda),
                         (torch.from_numpy(ints).to(cuda),), 20,
                         valid=torch.from_numpy(valid).to(cuda))
    assert res.counts.is_cuda


def test_kernel_rejects_other_dtypes_on_cuda(cuda):
    keys = torch.zeros(4, dtype=torch.int32, device=cuda)
    valid = torch.ones(4, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        segment_sum(keys, torch.zeros((4, 1), dtype=torch.int64,
                                      device=cuda), 3, valid)


def test_kmer_path_on_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(8)
    data = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8),
                      size=(3000, 64)).astype(np.uint8)
    lens = rng.integers(0, 65, 3000).astype(np.int32)
    results = []
    for dev in ("cpu", cuda):
        ds = from_host({"data": data, "len": lens}, num_shards=8, device=dev)
        before = kmod.LAUNCHES
        m = (MaRe(ds).map(image="kmer-stats", command="kmer-stats 7")
             .reduce_by_key(lambda r: r[0], value_by=lambda r: (r[1],),
                            op="sum"))
        done = m.dataset
        launched = kmod.LAUNCHES - before
        assert (launched > 0) == (torch.device(dev).type == "cuda")
        results.append(([collect_shard(done, s) for s in range(8)],
                         m.report().diagnostics))
    (cpu_shards, cpu_diag), (gpu_shards, gpu_diag) = results
    assert cpu_diag == gpu_diag
    for a, b in zip(cpu_shards, gpu_shards):
        for x, y in zip((a[0], a[1][0], a[2]), (b[0], b[1][0], b[2])):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the exchange: the kernel against its plain version, bit for bit
# ---------------------------------------------------------------------------

# name: (shards, rows a shard, valid share, capacity (None: lossless),
# keys: "kmer" distinct ascending int32 keys of a 4**k key space of about
# the rows, front-compacted (a combined k-mer table; capacity the key
# space's largest hash bucket), "snp" 24 keys with a fifth on one, "int64"
# wide keys,
# "salted" given destinations; leaves: "3" three 4-byte leaves, "wide" a
# pytree of mixed dtypes and widths)
EXCHANGE_CASES = {
    "kmer_scaled": (8, 1 << 18, 0.245, None, "kmer", "3"),
    "snp_skew": (8, 100_000, 1.0, None, "snp", "3"),
    "capacity_drops": (8, 50_000, 0.9, 3_000, "snp", "3"),
    "int64_keys": (5, 12_345, 0.7, None, "int64", "wide"),
    "salted_dests": (8, 40_000, 0.8, 9_000, "salted", "3"),
    "one_shard": (1, 4097, 0.5, 1000, "kmer", "wide"),
    "counts_zero": (4, 5000, 0.0, None, "snp", "3"),
    "no_rows": (3, 0, 0.0, None, "snp", "wide"),
    "tile_edges": (3, 3 * 4096 + 1, 1.0, None, "kmer", "3"),
}


def _exchange_case(name, dev):
    from repro_torch.core.shuffle import (hash_keys, keyed_bucket_capacity,
                                          salted_dest)
    n, rows, share, capacity, keys_kind, leaves_kind = EXCHANGE_CASES[name]
    rng = np.random.default_rng(sorted(EXCHANGE_CASES).index(name))
    counts = [int(rows * share * rng.uniform(0.9, 1.0)) if share < 1
              else rows for _ in range(n)]
    if keys_kind == "kmer":
        space = 4 ** max(1, math.ceil(math.log(max(rows, 2), 4)))
        keys = []
        for c in counts:
            present = np.sort(rng.choice(space, c, replace=False))
            keys.append(np.concatenate([present, np.setdiff1d(
                np.arange(space), present)])[:rows].astype(np.int32))
        capacity = capacity or keyed_bucket_capacity(space, n)
    elif keys_kind == "snp":
        keys = [np.where(rng.random(rows) < 0.2, 0,
                         rng.integers(0, 24, rows)).astype(np.int32)
                for _ in range(n)]
    else:
        keys = [rng.integers(-2 ** 40, 2 ** 40, rows) for _ in range(n)]
    capacity = capacity or rows
    keys = [torch.from_numpy(k).to(dev) for k in keys]
    leaves = []
    for k in keys:
        if leaves_kind == "3":
            leaves.append([k.to(torch.int32),
                           torch.from_numpy(rng.normal(size=rows).astype(
                               np.float32)).to(dev),
                           torch.arange(rows, dtype=torch.int32, device=dev)])
        else:
            leaves.append([
                torch.from_numpy(rng.integers(0, 255, (rows, 5)).astype(
                    np.uint8)).to(dev),
                torch.from_numpy(rng.integers(-9, 9, (rows, 3)).astype(
                    np.int16)).to(dev),
                torch.from_numpy(rng.normal(size=(rows, 2))).to(dev),
                torch.from_numpy(rng.random(rows) < 0.5).to(dev),
                k.to(torch.int64)])
    cnts = [torch.tensor(c, dtype=torch.int32, device=dev) for c in counts]
    if keys_kind == "salted":
        dests = [salted_dest(k, n, 3) for k in keys]
        return leaves, cnts, capacity, dict(dests=dests), dests
    return (leaves, cnts, capacity, dict(keys=keys),
            [hash_keys(k) % n for k in keys])


@pytest.mark.parametrize("name", sorted(EXCHANGE_CASES))
def test_exchange_kernel_matches_plain_version(cuda, name):
    """Received rows and zero tails, counts, sends and drops, bit for bit,
    in one launch on the case's route."""
    from repro_torch.kernels.exchange import exchange, exchange_ref
    from repro_torch.kernels.exchange import kernel as xmod
    leaves, cnts, capacity, by, dests = _exchange_case(name, cuda)
    xmod.reset_launches()
    got = exchange(leaves, cnts, capacity, **by)
    route = "dests" if "dests" in by else "hash"
    assert xmod.LAUNCHES == 1 and xmod.LAUNCHES_BY_ROUTE[route] == 1
    want = exchange_ref(leaves, cnts, capacity, dests)
    torch.cuda.synchronize()
    for g, w in zip(got.leaves, want.leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    for field in ("counts", "send_counts", "dropped"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    if name == "capacity_drops":
        assert int(got.dropped.sum()) > 0


def test_exchange_kernel_adds_no_synchronising_call(cuda):
    from repro_torch.kernels.exchange import exchange
    leaves, cnts, capacity, by, _ = _exchange_case("snp_skew", cuda)
    exchange(leaves, cnts, capacity, **by)        # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = exchange(leaves, cnts, capacity, **by)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.counts.is_cuda


def test_exchange_kernel_raises_past_its_limits(cuda):
    from repro_torch.kernels.exchange import exchange
    from repro_torch.kernels.exchange import kernel as xmod
    n = xmod.MAX_SHARDS + 1
    k = torch.zeros(8, dtype=torch.int32, device=cuda)
    c = torch.tensor(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        exchange([[k]] * n, [c] * n, 8, keys=[k] * n)
    with pytest.raises(ValueError):
        exchange([[k] * (xmod.MAX_LEAVES + 1)], [c], 8, keys=[k])
    xmod.reset_launches()
    exchange([[k]] * xmod.MAX_SHARDS, [c] * xmod.MAX_SHARDS, 8,
             keys=[k] * xmod.MAX_SHARDS)
    assert xmod.LAUNCHES == 1


# ---------------------------------------------------------------------------
# flash attention and RMSNorm: each kernel against its plain version
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # name: (b, hq, hkv, sq, sk, d, causal, window)
    "gqa_causal": (2, 4, 2, 64, 64, 32, True, None),
    "not_causal": (1, 8, 2, 40, 40, 64, False, None),
    "window": (1, 4, 4, 96, 96, 32, True, 32),
    "right_aligned": (1, 2, 1, 16, 128, 32, True, None),
    "unaligned": (1, 3, 1, 33, 77, 16, True, None),
    "d128": (2, 2, 2, 128, 128, 128, True, None),
    "d96_window_long": (1, 4, 2, 300, 300, 96, True, 70),
    "llama_layer_short": (1, 32, 8, 200, 200, 64, True, None),
    "rows_without_keys": (1, 4, 2, 100, 37, 64, True, None),
    # hymba's prefill: GQA group 5, head_dim 64, window 1024 (and global)
    "hymba_window_1024": (1, 25, 5, 2048, 2048, 64, True, 1024),
    "hymba_global": (1, 25, 5, 2048, 2048, 64, True, None),
    # the wgmma route's 128-key tiles: Sk just under, at and past a tile
    "sk_127": (1, 4, 2, 127, 127, 64, True, None),
    "sk_128": (1, 4, 2, 128, 128, 64, True, None),
    "sk_129": (1, 4, 2, 129, 129, 64, True, None),
    "sk_255": (1, 4, 2, 255, 255, 64, True, None),
    # query tiles shorter than 128 rows against a long cache
    "sq_1_sk_2048": (2, 8, 2, 1, 2048, 64, True, None),
    "sq_96_sk_2048": (2, 8, 2, 96, 2048, 64, True, None),
    # a window of one key, and one that starts inside a key tile
    "window_1": (1, 4, 2, 300, 300, 64, True, 1),
    "window_200": (1, 4, 2, 700, 700, 64, True, 200),
    "group_5_d128": (1, 10, 2, 300, 300, 128, True, None),
    # Sq > Sk: whole query tiles of rows without keys
    "sq_gt_sk_d128": (1, 4, 2, 300, 100, 128, True, None),
    # whisper-base's encoder self-attention over 1,500 frames (the last
    # 128-key tile holds 92 keys) and the teacher-forced forward's cross
    # attention (448 queries against them), not causal; internvl2-1b's
    # prefill over 256 patches and 2,048 tokens, GQA group 7
    "whisper_encoder": (1, 8, 8, 1500, 1500, 64, False, None),
    "whisper_cross": (1, 8, 8, 448, 1500, 64, False, None),
    "internvl2_prefill": (1, 14, 2, 2304, 2304, 64, True, None),
}
#: Served shapes, in bf16 also held by relative RMS error (chip_smoke's
#: limit, which rejects whisper's tail-tile keys left unmasked)
SERVED_FLASH_CASES = ("whisper_encoder", "whisper_cross",
                      "internvl2_prefill")
# bf16 output rounds once to 8 mantissa bits (|o| < 4 here): 2e-2, as the
# reference's kernel tests; f32 differs only in summation order: 2e-5
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain_version(cuda, name, dtype):
    b, hq, hkv, sq, sk, d, causal, window = FLASH_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((b, hq, sq, d), device=cuda, generator=g).to(dtype)
    k = torch.randn((b, hkv, sk, d), device=cuda, generator=g).to(dtype)
    v = torch.randn((b, hkv, sk, d), device=cuda, generator=g).to(dtype)
    before, by_route = fmod.LAUNCHES, dict(fmod.LAUNCHES_BY_ROUTE)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fmod.LAUNCHES - before == 1
    kind = fmod.route(dtype, d, cuda)
    assert {r: fmod.LAUNCHES_BY_ROUTE[r] - by_route[r]
            for r in by_route} == {r: int(r == kind) for r in by_route}
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(
        q.float().reshape(b * hq, sq, d), k.float().reshape(b * hkv, sk, d),
        v.float().reshape(b * hkv, sk, d), hq // hkv, causal=causal,
        window=window).reshape(b, hq, sq, d)
    err = float((got.float() - want).abs().max())
    assert err < FLASH_TOL[dtype], (name, dtype, err)
    if dtype == torch.bfloat16 and name in SERVED_FLASH_CASES:
        rel = float((got.float() - want).norm() / want.norm())
        assert rel <= cs.FLASH_REL_RMS_TOL, (name, rel)
    if sq > sk and causal:
        # queries right-aligned past the keys see none: exactly 0
        assert bool((got[:, :, :sq - sk] == 0).all())


@pytest.mark.parametrize("sm_scale", [-0.1, 0.0, 0.3])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_takes_any_scale(cuda, sm_scale, d):
    """A scale >= 0 folds into the exponent's FFMA; a negative one keeps
    the scaled maximum: both are the plain version's function."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn((1, 8, 300, d), device=cuda, generator=g).bfloat16()
    k = torch.randn((1, 2, 300, d), device=cuda, generator=g).bfloat16()
    v = torch.randn((1, 2, 300, d), device=cuda, generator=g).bfloat16()
    got = flash_attention(q, k, v, window=100, sm_scale=sm_scale)
    want = flash_attention_plain(
        q.float().reshape(8, 300, d), k.float().reshape(2, 300, d),
        v.float().reshape(2, 300, d), 4, window=100,
        sm_scale=sm_scale).reshape(1, 8, 300, d)
    assert float((got.float() - want).abs().max()) < 2e-2


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt")], ids=str)
def test_flash_call_moves_only_its_route_counter(cuda, dtype, d, want):
    q = torch.randn((4, 130, d), device=cuda).to(dtype)
    k = torch.randn((2, 130, d), device=cuda).to(dtype)
    fmod.reset_launches()
    fmod.flash_attention_kernel(q, k, k, group=2)
    torch.cuda.synchronize()
    assert fmod.LAUNCHES == 1
    assert fmod.LAUNCHES_BY_ROUTE == {"wgmma": int(want == "wgmma"),
                                      "simt": int(want == "simt")}


def test_flash_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.zeros((2, 8, 24), device=cuda)
    with pytest.raises(ValueError):
        fmod.flash_attention_kernel(q, q, q, group=1)


# (8192, 2048), (4, 2048): Llama's prefill and decode rows; 1600: hymba's
# width; 8192: 128 threads a row on the one-pass path
RMS_SHAPES = [(8192, 2048), (4, 2048), (33, 100), (7, 1000), (1, 8),
              (300, 1600), (4, 1600), (64, 8192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_rmsnorm_kernel_matches_plain_version(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(shape, device=cuda, generator=g).to(dtype)
    # norm scales near 1, as a model's are: |out| stays under 8, so one
    # bf16 rounding of the output is under 2e-2
    w = (1 + 0.1 * torch.randn(shape[-1], device=cuda,
                               generator=g)).to(dtype)
    before, by_path = rmod.LAUNCHES, dict(rmod.LAUNCHES_BY_PATH)
    got = rmsnorm(x, w, eps=1e-6)
    torch.cuda.synchronize()
    assert rmod.LAUNCHES - before == 1
    kind = rmod.path(shape[-1], dtype)
    assert rmod.LAUNCHES_BY_PATH[kind] - by_path[kind] == 1
    if shape[-1] in (2048, 1600) or (shape[-1] == 8192
                                     and dtype == torch.bfloat16):
        assert kind == "one_pass"
    want = rmsnorm_ref(x.float(), w.float(), eps=1e-6)
    if dtype == torch.float32:
        # rsqrtf and the warp's summation order: within 1e-6 relative
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert float((got.float() - want).abs().max()) < 2e-2


# ---------------------------------------------------------------------------
# the LM prefill goes through the flash kernel, once per layer
# ---------------------------------------------------------------------------

def test_prefill_launches_flash_once_per_layer(cuda):
    """Two layers of Llama-3.2-1B at full width (bf16): the prefill makes
    one flash launch per layer, on the wgmma route, and no RMSNorm launch
    (the model's norms take the plain version, as the reference's do),
    and its logits agree
    with the plain-attention path within 10% of the largest |logit|
    (bf16 rounding at other places; see chip_smoke.py)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("llama3.2-1b").scaled(num_layers=2)
    model = build_model(cfg, device=cuda)
    params = model.init(5)
    toks = torch.randint(0, cfg.vocab_size, (2, 200), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(5))
    f0, r0 = fmod.LAUNCHES, rmod.LAUNCHES
    by_route = dict(fmod.LAUNCHES_BY_ROUTE)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, 208)
        torch.cuda.synchronize()
        assert fmod.LAUNCHES - f0 == 2 and rmod.LAUNCHES == r0
        # bf16 at head dim 64: both launches on the tensor-core route
        assert fmod.LAUNCHES_BY_ROUTE["wgmma"] - by_route["wgmma"] == 2
        assert fmod.LAUNCHES_BY_ROUTE["simt"] == by_route["simt"]
        assert logits.shape == (2, 200, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()) and cache.pos == 200
        plain, _ = build_model(cfg.scaled(attn_impl="ref"),
                               device=cuda).prefill(params,
                                                    {"tokens": toks}, 200)
        lg, cache = model.decode_step(params, cache, toks[:, -1])
        assert fmod.LAUNCHES - f0 == 2          # decode: no kernel
    diff = float((logits.float() - plain.float()).abs().max())
    assert diff <= 0.1 * float(plain.float().abs().max()), diff
    assert lg.shape == (2, cfg.vocab_size) and cache.pos == 201


def test_vlm_and_audio_launch_flash_as_the_reference_chooses(cuda):
    """Two layers of internvl2-1b and 2 + 2 of whisper-base at full width
    (bf16) on the wgmma route: internvl2's prefill over 64 patches and 200
    tokens launches once per layer; whisper's prefill once per encoder
    layer over its 1,500 frames (the decoder's attention stays plain, as
    the reference's), a decode step never, the forward three times a
    layer pair.  Logits within 10% of the largest |logit| of the
    plain-attention path, as the Llama prefill's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    g = torch.Generator(device=cuda).manual_seed(6)
    vlm = get_config("internvl2-1b").scaled(num_layers=2, num_patches=64)
    audio = get_config("whisper-base").scaled(num_layers=2,
                                              encoder_layers=2)
    for cfg, extra, s, want in (
            (vlm, "patch_embeds", 200, 2), (audio, "frames", 100, 2)):
        model = build_model(cfg, device=cuda)
        params = model.init(6)
        shape = (2, cfg.num_patches or cfg.encoder_seq, cfg.d_model)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, s),
                                         device=cuda, generator=g),
                 extra: torch.randn(shape, device=cuda, generator=g).to(
                     cfg.param_dtype)}
        f0, by_route = fmod.LAUNCHES, dict(fmod.LAUNCHES_BY_ROUTE)
        p = cfg.num_patches if extra == "patch_embeds" else 0
        with torch.no_grad():
            logits, cache = model.prefill(params, batch, p + s + 1)
            torch.cuda.synchronize()
            assert fmod.LAUNCHES - f0 == want
            assert fmod.LAUNCHES_BY_ROUTE["wgmma"] - by_route["wgmma"] == \
                want and fmod.LAUNCHES_BY_ROUTE["simt"] == by_route["simt"]
            model.decode_step(params, cache, batch["tokens"][:, -1])
            assert fmod.LAUNCHES - f0 == want
            plain, _ = build_model(cfg.scaled(attn_impl="ref"),
                                   device=cuda).prefill(params, batch,
                                                        p + s)
            if extra == "frames":
                f1 = fmod.LAUNCHES
                shapes = dict(fmod.LAUNCHES_BY_SHAPE)
                model.forward(params, batch)
                assert fmod.LAUNCHES - f1 == 3 * 2
                moved = {key: n - shapes.get(key, 0) for key, n
                         in fmod.LAUNCHES_BY_SHAPE.items()
                         if n != shapes.get(key, 0)}
                frames = cfg.encoder_seq
                assert moved == {
                    ("wgmma", 16, 1, frames, frames, 64, False, None): 2,
                    ("wgmma", 16, 1, s, frames, 64, False, None): 2,
                    ("wgmma", 16, 1, s, s, 64, True, None): 2}, moved
        assert logits.shape == (2, p + s, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        diff = float((logits.float() - plain.float()).abs().max())
        assert diff <= 0.1 * float(plain.float().abs().max()), (cfg.name,
                                                                 diff)


def test_snp_calling_on_cuda_equals_cpu(cuda):
    """The SNP pipeline at 8 shards on both devices, each against the
    numpy oracle of its formulas (``chip_smoke.snp_oracle``): the same
    chromosomes and drop counter; the same variants in the same order but
    for reads whose score lies within 1e-5 of 0; each device's scores
    within 1e-5 of numpy's (the surrogate's float32 matmuls and sin in
    three libraries, |score| < 20); one exchange launch on the card (the
    ``hash`` route), none on the CPU, and no other kernel launch."""
    from repro_torch.kernels.exchange import kernel as xmod
    library = cs.make_library(50000, 4)
    o_chrom, o_score, _ = cs.snp_oracle(library[0])
    out = {}
    for dev in ("cpu", cuda):
        before = [m.LAUNCHES for m in cs.kernel_modules().values()]
        xmod.reset_launches()
        chain = cs.snp_calling(library, 8, dev)
        chrom, score, ids = chain.collect(shard=0)
        assert [m.LAUNCHES for m in cs.kernel_modules().values()] == before
        on_card = int(torch.device(dev).type == "cuda")
        assert xmod.LAUNCHES_BY_ROUTE == {"hash": on_card, "dests": 0}
        assert chain.report().diagnostics == {"stage1.shuffle_dropped": 0}
        np.testing.assert_array_equal(chrom, o_chrom[ids], err_msg=str(dev))
        err = np.abs(score - o_score[ids])
        assert float(err.max()) <= 1e-5, (str(dev), float(err.max()),
                                          int((err > 1e-5).sum()),
                                          np.flatnonzero(err > 1e-5)[:10])
        out[str(dev)] = (chrom, ids)
    (cc, ci), (gc, gi) = out["cpu"], out[str(cuda)]
    keep_c, keep_g = np.isin(ci, gi), np.isin(gi, ci)
    assert (np.abs(o_score[ci[~keep_c]]) <= 1e-5).all()
    assert (np.abs(o_score[gi[~keep_g]]) <= 1e-5).all()
    np.testing.assert_array_equal(ci[keep_c], gi[keep_g])
    np.testing.assert_array_equal(cc[keep_c], gc[keep_g])


# ---------------------------------------------------------------------------
# MoE dispatch and top-k: each kernel against its plain version, bit for bit
# ---------------------------------------------------------------------------

DISPATCH_CASES = {
    # name: (n, groups, lowest id, highest id + 1)
    "prefill": (65536, 32, 0, 32),
    "decode": (32, 32, 0, 32),
    "one": (1, 32, 0, 32),
    "one_group": (3000, 1, 0, 1),
    "g64_n64": (64, 64, 0, 64),
    "ragged_tile": (65536 + 77, 32, 0, 32),
    "outside_ids": (10000, 8, -3, 11),
    "many_groups": (50000, 4000, 0, 4000),
    "empty": (0, 5, 0, 5),
}


@pytest.mark.parametrize("name", sorted(DISPATCH_CASES))
def test_dispatch_kernel_matches_plain_version(cuda, name):
    n, groups, lo, hi = DISPATCH_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(13)
    a = torch.randint(lo, hi, (n,), device=cuda, dtype=torch.int32,
                      generator=g)
    before = dmod.LAUNCHES
    p, c = moe_dispatch(a, groups)
    torch.cuda.synchronize()
    assert dmod.LAUNCHES - before == (1 if n else 0)
    rp, rc = dispatch_ref(a, groups)
    assert p.dtype == c.dtype == torch.int32 and p.is_cuda
    assert torch.equal(p, rp) and torch.equal(c, rc)


def test_dispatch_kernel_rejects_other_dtypes_on_cuda(cuda):
    with pytest.raises(TypeError):
        dmod.moe_dispatch_kernel(torch.zeros(4, dtype=torch.int64,
                                             device=cuda), 3)


TOPK_CASES = {
    # name: (n, k, valid_count, duplicates)
    "shard": (262144, 30, 262144, False),
    "shard_dup": (262144, 30, 200000, True),
    "past_valid": (1000, 30, 10, False),
    "none_valid": (1000, 30, 0, False),
    "k_is_n": (100, 100, 100, False),
    "ragged_tile": (4096 * 3 + 5, 64, 4096 * 3, True),
    "three_levels": (1 << 23, 1024, 1 << 23, True),
    "one": (1, 1, 1, False),
}


@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_topk_kernel_matches_plain_version(cuda, name):
    n, k, vc, dup = TOPK_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(14)
    s = torch.randn((n,), device=cuda, generator=g)
    if dup:
        s = torch.round(s * 4) / 4
    vct = torch.tensor(vc, device=cuda, dtype=torch.int32)
    before = tmod.LAUNCHES
    v, i = topk_reduce(s, k, vct)
    torch.cuda.synchronize()
    assert tmod.LAUNCHES - before == 1
    rv, ri = topk_ref(s, k, vct)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    # python int valid_count, and the CPU's plain version
    v2, i2 = topk_reduce(s, k, vc)
    cv, ci = topk_ref(s.cpu(), k, vc)
    assert torch.equal(v2.cpu(), cv) and torch.equal(i2.cpu(), ci)


def test_topk_kernel_orders_bits_like_lax_top_k(cuda):
    bits = np.float32([-0.0, 0.0, 1.0, np.nan, -0.0, 0.0, -np.inf,
                       -np.inf, 2.0]).view(np.int32)
    bits[3], bits[8] = 0x7FC00000, -0x00400000    # +NaN, -NaN (0xFFC00000)
    s = torch.from_numpy(bits.view(np.float32)).to(cuda)
    v, i = topk_reduce(s, 9)
    assert i.tolist() == [3, 2, 1, 5, 0, 4, 6, 7, 8]
    rv, ri = topk_ref(s, 9)
    assert torch.equal(i, ri)


def test_topk_kernel_rejects_bad_arguments(cuda):
    s = torch.zeros(10, device=cuda)
    with pytest.raises(ValueError):
        topk_reduce(s, 11)
    with pytest.raises(ValueError):
        topk_reduce(torch.zeros(5000, device=cuda), 1025)
    with pytest.raises(TypeError):
        tmod.topk_reduce_kernel(s.double(), 3, 10)


# each route at its edges, its counter asserted: the cluster route up to
# dmod.CLUSTER_REACH ids over dmod.CLUSTER_GROUPS groups, the tiled route
# past either; the select route for k <= 32, the tree route past it
DISPATCH_ROUTE_CASES = {
    # name: (n, groups, lowest id, highest id + 1, hot id or None)
    "decode_one_warp": (32, 32, 0, 32, None),
    "two_blocks": (4097, 32, 0, 32, None),
    "prefill": (65536, 32, 0, 32, None),
    "reach": (8 * 1024 * 16, 32, 0, 32, None),
    "reach_plus_one": (8 * 1024 * 16 + 1, 32, 0, 32, None),
    "reach_one_hot_group": (8 * 1024 * 16, 32, 0, 32, 31),
    "most_groups": (30000, 1024, -5, 1029, None),
    "most_groups_plus_one": (30000, 1025, 0, 1025, None),
    "one_id_one_group": (1, 1, 0, 1, None),
}


@pytest.mark.parametrize("name", sorted(DISPATCH_ROUTE_CASES))
def test_dispatch_route_matches_plain_version(cuda, name):
    n, groups, lo, hi, hot = DISPATCH_ROUTE_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(15)
    a = torch.randint(lo, hi, (n,), device=cuda, dtype=torch.int32,
                      generator=g)
    if hot is not None:
        a.fill_(hot)
    kind = dmod.route(n, groups, cuda)
    assert kind == ("tiled" if "plus_one" in name else "cluster")
    before = dict(dmod.LAUNCHES_BY_ROUTE)
    p, c = dmod.moe_dispatch_kernel(a, groups)
    torch.cuda.synchronize()
    assert {r: v - before[r] for r, v in dmod.LAUNCHES_BY_ROUTE.items()
            } == {r: int(r == kind) for r in before}
    rp, rc = dispatch_ref(a, groups)
    assert torch.equal(p, rp) and torch.equal(c, rc)


@pytest.mark.parametrize("n", [32, 65536])
def test_dispatch_tiled_kernel_matches_plain_version(cuda, n):
    """The first design's three passes, kept as the tiled route, at sizes
    the wrapper sends to the cluster route (``chip_smoke.py`` times them
    there in turns)."""
    a = torch.randint(0, 32, (n,), device=cuda, dtype=torch.int32,
                      generator=torch.Generator(device=cuda).manual_seed(16))
    before = dmod.LAUNCHES
    p, c = dmod.tiled_launch(a, 32)
    torch.cuda.synchronize()
    assert dmod.LAUNCHES == before
    rp, rc = dispatch_ref(a, 32)
    assert torch.equal(p, rp) and torch.equal(c, rc)


TOPK_ROUTE_CASES = {
    # name: (n, k, valid_count, scores: "randn", "asc", "desc", "equal",
    # "special" (NaNs, +-inf, +-0 among ties))
    "k1": (262144, 1, 262144, "randn"),
    "k32": (262144, 32, 262144, "randn"),
    "k33": (262144, 33, 262144, "randn"),
    "ascending": (262144, 30, 262144, "asc"),
    "descending": (262144, 30, 262144, "desc"),
    "all_equal": (262144, 30, 262144, "equal"),
    "special": (262144, 30, 262144, "special"),
    "special_k32_count": (100000, 32, 99001, "special"),
    "special_tree": (100000, 40, 99001, "special"),
    "none_valid_k32": (5000, 32, 0, "randn"),
    "tree_combine_60": (60, 30, 60, "randn"),
    "tree_combine_120": (120, 30, 120, "randn"),
    "k_is_n_32": (32, 32, 32, "randn"),
    "one_block_plus_one": (2049, 30, 2049, "randn"),
    "eight_shards": (8 * 262144, 30, 8 * 262144, "randn"),
}


def _topk_scores(dev, n, kind):
    if kind == "asc":
        return torch.arange(n, device=dev, dtype=torch.float32)
    if kind == "desc":
        return torch.arange(n, 0, -1, device=dev, dtype=torch.float32)
    if kind == "equal":
        return torch.full((n,), 0.5, device=dev)
    if kind == "special":
        return cs.special_scores(dev, n, 17)
    return torch.randn((n,), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(17))


@pytest.mark.parametrize("name", sorted(TOPK_ROUTE_CASES))
def test_topk_route_matches_plain_version(cuda, name):
    n, k, vc, kind = TOPK_ROUTE_CASES[name]
    s = _topk_scores(cuda, n, kind)
    vct = torch.tensor(vc, device=cuda, dtype=torch.int32)
    want_route = tmod.route(k, n, cuda)
    assert want_route == ("select" if k <= 32 else "tree")
    before = dict(tmod.LAUNCHES_BY_ROUTE)
    v, i = tmod.topk_reduce_kernel(s, k, vct)
    torch.cuda.synchronize()
    assert {r: c - before[r] for r, c in tmod.LAUNCHES_BY_ROUTE.items()
            } == {r: int(r == want_route) for r in before}
    rv, ri = topk_ref(s, k, vct)
    # bits, so that NaNs and signed zeros count
    assert torch.equal(v.view(torch.int32), rv.view(torch.int32))
    assert torch.equal(i, ri)


def test_topk_select_calls_in_a_row_and_in_a_graph(cuda):
    """The select route's last-block ticket is reset by each call: many
    calls in a row, and replays of a captured graph, stay right."""
    g = torch.Generator(device=cuda).manual_seed(18)
    xs = [torch.randn((262144,), device=cuda, generator=g)
          for _ in range(4)]
    vct = torch.tensor(262144, device=cuda, dtype=torch.int32)
    for _ in range(3):
        for x in xs:
            v, i = topk_reduce(x, 30, vct)
            rv, ri = topk_ref(x, 30, vct)
            assert torch.equal(v, rv) and torch.equal(i, ri)
    x = xs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        topk_reduce(x, 30, vct)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = topk_reduce(x, 30, vct)
    for src in xs[::-1]:
        x.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        rv, ri = topk_ref(src, 30, vct)
        assert torch.equal(out[0], rv) and torch.equal(out[1], ri)


def test_topk_tree_kernel_matches_plain_version(cuda):
    """The first design's levels of argmax rounds, kept as the tree
    route, at a k the wrapper sends to the select route
    (``chip_smoke.py`` times it there in turns)."""
    s = torch.randn((262144,), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(19))
    vct = torch.tensor(262100, device=cuda, dtype=torch.int32)
    before = tmod.LAUNCHES
    v, i = tmod.tree_launch(s, 30, vct)
    torch.cuda.synchronize()
    assert tmod.LAUNCHES == before
    rv, ri = topk_ref(s, 30, vct)
    assert torch.equal(v, rv) and torch.equal(i, ri)


def test_moe_layers_launch_dispatch_once_per_layer(cuda):
    """Two layers of granite-moe-1b-a400m at full width (bf16): one
    dispatch launch per layer in a prefill and in a decode step, and the
    MoE layer's output equals its output with the plain dispatch."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    cfg = get_config("granite-moe-1b-a400m").scaled(num_layers=2)
    model = build_model(cfg, device=cuda)
    params = model.init(6)
    toks = torch.randint(0, cfg.vocab_size, (2, 300), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(6))
    d0, f0 = dmod.LAUNCHES, fmod.LAUNCHES
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, 304)
        torch.cuda.synchronize()
        assert dmod.LAUNCHES - d0 == 2 and fmod.LAUNCHES - f0 == 2
        lg, cache = model.decode_step(params, cache, toks[:, -1])
        assert dmod.LAUNCHES - d0 == 4 and fmod.LAUNCHES - f0 == 2
        assert bool(torch.isfinite(logits).all()) and lg.shape == (
            2, cfg.vocab_size)
        x = torch.randn((2, 300, cfg.d_model), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(7)
                        ).to(torch.bfloat16)
        p = params["blocks"][0]["moe"]
        y, st = moe_lib.moe_ffn(p, x, cfg)
        orig = moe_lib.moe_dispatch
        try:
            moe_lib.moe_dispatch = lambda a, G: dispatch_ref(
                a.to(torch.int32), G)
            y_plain, st_plain = moe_lib.moe_ffn(p, x, cfg)
        finally:
            moe_lib.moe_dispatch = orig
    assert torch.equal(y, y_plain)
    assert torch.equal(st.aux_loss, st_plain.aux_loss)


def test_virtual_screening_on_cuda_equals_cpu(cuda):
    """The VS pipeline at 8 shards: the same 30 molecules on both
    devices, scores within 1e-5 (the surrogate's matmuls), one top-k
    launch per toolbox/topk combine on the card."""
    library = cs.make_library(50000, seed=2)
    out = {}
    for dev in ("cpu", cuda):
        before = tmod.LAUNCHES
        out[str(dev)] = cs.virtual_screening(library, 8, dev).collect(
            shard=0)
        launched = tmod.LAUNCHES - before
        assert launched == (cs.topk_combines(8, 2) if dev is cuda else 0)
    (cs_, ci), (gs, gi) = out["cpu"], out[str(cuda)]
    np.testing.assert_array_equal(ci, gi)
    np.testing.assert_allclose(gs, cs_, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# selective scan: the kernel against its plain version
# ---------------------------------------------------------------------------

SSM_CASES = {
    # name: (b, t, d, n, carried h0); the chunked route's chunk is
    # smod.CHUNK = 128 steps
    "hymba_prefill": (4, 2048, 1600, 16, False),
    "hymba_decode": (4, 1, 1600, 16, True),
    "odd_t_33": (2, 33, 64, 16, True),
    "odd_t_100": (1, 100, 48, 8, True),
    "chunk_minus_1": (2, 127, 96, 16, True),
    "chunk": (2, 128, 96, 16, True),
    "chunk_plus_1": (2, 129, 96, 16, True),
    "t_2048_plus_17": (2, 2065, 200, 16, True),
    "odd_d": (3, 50, 1001, 16, False),
    "odd_d_decode": (3, 1, 1001, 16, True),
    "n2": (2, 40, 37, 2, True),
    "n4": (2, 40, 37, 4, True),
    "n5": (1, 17, 9, 5, True),
    "n5_decode": (2, 1, 9, 5, True),
    "n8": (2, 40, 37, 8, True),
    "n32": (1, 20, 40, 32, True),
    "n32_decode": (2, 1, 40, 32, True),
}
# chip_smoke.ssm_compare holds y (and h) within 1e-3 of the largest
# magnitude: both versions accumulate in f32, in another order


def ssm_inputs(dev, seed, b, t, d, n, dtype, carried=True, **kw):
    """``chip_smoke.ssm_inputs`` from a seeded generator: inputs shaped
    like the model's."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return cs.ssm_inputs(dev, g, b, t, d, n, dtype, carried, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(SSM_CASES))
def test_ssm_kernel_matches_plain_version(cuda, name, dtype):
    """One launch, on the route ``route`` names (step for T = 1, chunked
    otherwise), within 1e-3 of the largest |value| of the plain
    version."""
    b, t, d, n, carried = SSM_CASES[name]
    args = ssm_inputs(cuda, 13, b, t, d, n, dtype, carried)
    kind, _, _, _ = cs.ssm_checked(name, args)
    assert kind == ("step" if t == 1 else "chunked")


def test_ssm_long_carried_state_reaches_every_chunk(cuda):
    """dt ~2.5e-3 and a large h0: h0 still weighs in y past the first
    chunk, so the carries between chunks are what the check holds."""
    args = ssm_inputs(cuda, 17, 2, 2048, 256, 16, torch.bfloat16,
                      h0_scale=10.0, dt_shift=-6.0)
    _, (y, _), err, _ = cs.ssm_checked("long carried", args)
    y0, _ = smod.ssm_scan_kernel(*args[:4], torch.zeros_like(args[4]))
    assert float((y - y0)[:, smod.CHUNK:].abs().max()) > 100 * err


def test_ssm_serial_kernel_matches_plain_version(cuda):
    """The serial kernel the routes replaced, kept for timing beside
    them: still right, and no launch counted."""
    for t in (1, 300):
        args = ssm_inputs(cuda, 18, 2, t, 96, 16, torch.bfloat16)
        before = (smod.LAUNCHES, dict(smod.LAUNCHES_BY_ROUTE))
        got = cs.ssm_serial(*args)
        assert (smod.LAUNCHES, smod.LAUNCHES_BY_ROUTE) == before
        cs.ssm_compare("serial", got, ssm_scan_ref(*args))


def test_ssm_kernel_halves_chain_to_one_pass(cuda):
    xc, x_proj, dt_bias, a_log, h0 = ssm_inputs(cuda, 14, 2, 300, 96, 16,
                                                torch.bfloat16)
    y, h = ssm_scan_fused(xc, x_proj, dt_bias, a_log, h0)
    y1, h1 = ssm_scan_fused(xc[:, :137], x_proj, dt_bias, a_log, h0)
    y2, h2 = ssm_scan_fused(xc[:, 137:], x_proj, dt_bias, a_log, h1)
    cs.ssm_compare("chained", (torch.cat([y1, y2], 1), h2), (y, h))
    # a decode step after a prefill == one pass over both
    yd, hd = ssm_scan_fused(xc[:, 299:], x_proj, dt_bias, a_log,
                            ssm_scan_fused(xc[:, :299], x_proj, dt_bias,
                                           a_log, h0)[1])
    cs.ssm_compare("prefill then step", (yd, hd), (y[:, 299:], h))


def test_ssm_kernel_rejects_what_it_does_not_take(cuda):
    xc, x_proj, dt_bias, a_log, h0 = ssm_inputs(cuda, 15, 1, 4, 8, 4,
                                                torch.float32)
    with pytest.raises(TypeError):
        smod.ssm_scan_kernel(xc.bfloat16(), x_proj, dt_bias, a_log, h0)
    with pytest.raises(TypeError):
        smod.ssm_scan_kernel(xc, x_proj, dt_bias, a_log.double(), h0)
    big = ssm_inputs(cuda, 15, 1, 4, 8, 33, torch.float32)
    with pytest.raises(ValueError, match="n <="):
        smod.ssm_scan_kernel(*big)
    # ssm_scan_fused widens a mixed pair to f32 instead
    y, _ = ssm_scan_fused(xc.bfloat16(), x_proj, dt_bias, a_log, h0)
    cs.ssm_compare("mixed dtypes", (y,), ssm_scan_ref(
        xc.bfloat16(), x_proj, dt_bias, a_log, h0)[:1])


def test_hybrid_layers_launch_ssm_once_per_layer(cuda):
    """Two layers of hymba-1.5b at full width (bf16; one sliding-window
    layer, one global): one SSM launch per layer in a prefill and in a
    decode step, one flash launch per layer in the prefill.  On an f32
    copy of the weights the prefill's logits through the kernel are
    within 1% of the largest |logit| of the chunked-scan route's (summation
    order only; measured 4e-5).  The bf16 routes are not compared with
    each other: the bf16 hybrid stack amplifies rounding (see
    chip_smoke.py, SSM_ROUTE_TOL_FRAC)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import ssm as ssm_lib
    cfg = get_config("hymba-1.5b").scaled(num_layers=2, global_layers=(1,))
    model = build_model(cfg, device=cuda)
    params = model.init(8)
    toks = torch.randint(0, cfg.vocab_size, (2, 1100), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(8))
    s0, f0 = smod.LAUNCHES, fmod.LAUNCHES
    r0 = dict(smod.LAUNCHES_BY_ROUTE)

    def by_route():
        return {r: smod.LAUNCHES_BY_ROUTE[r] - r0[r] for r in r0}

    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": toks}, 1104)
        torch.cuda.synchronize()
        assert smod.LAUNCHES - s0 == 2 and fmod.LAUNCHES - f0 == 2
        assert by_route() == {"chunked": 2, "step": 0}
        lg, caches = model.decode_step(params, caches, toks[:, -1])
        assert smod.LAUNCHES - s0 == 4 and fmod.LAUNCHES - f0 == 2
        assert by_route() == {"chunked": 2, "step": 2}
        assert [c.kv.k.shape[2] for c in caches] == [1024, 1104]
        assert bool(torch.isfinite(logits).all()) and lg.shape == (
            2, cfg.vocab_size)
        m32 = build_model(cfg.scaled(dtype="float32"), device=cuda)
        p32 = copy.deepcopy(params).float()
        kern, _ = m32.prefill(p32, {"tokens": toks}, 1100)
        assert smod.LAUNCHES - s0 == 6
        orig = ssm_lib.resolve_scan_impl
        try:
            ssm_lib.resolve_scan_impl = lambda device: "chunked"
            plain, _ = m32.prefill(p32, {"tokens": toks}, 1100)
        finally:
            ssm_lib.resolve_scan_impl = orig
        assert smod.LAUNCHES - s0 == 6
    diff = float((kern - plain).abs().max())
    assert diff <= 1e-2 * float(plain.abs().max()), diff


# -- flash-attention backward and the wrappers' gradients ---------------------

FLASH_BWD_CASES = {
    # b, hq, hkv, sq, sk, d, causal, window
    "causal": (2, 4, 4, 130, 130, 64, True, None),
    "gqa 4 d=128": (1, 8, 2, 100, 100, 128, True, None),
    "window 17": (1, 4, 2, 150, 150, 32, True, 17),
    "not causal Sk tail": (2, 2, 2, 70, 133, 16, False, None),
    "rows without keys": (1, 4, 2, 150, 50, 96, True, None),
    "causal gqa 4 d=128 Sk tail": (1, 8, 2, 200, 333, 128, True, None),
    "rows without keys d=64": (1, 4, 2, 150, 50, 64, True, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("name", sorted(FLASH_BWD_CASES))
def test_flash_backward_kernel_matches_plain_version(cuda, name, dtype):
    """The backward kernel against the plain backward taken in f32 on the
    same inputs, by relative RMS error (chip_smoke's limits); two
    launches give the same bytes; a row without keys gets a zero dq; each
    case on its route: ``wgmma`` for bf16 at head dim 64 or 128, ``simt``
    otherwise."""
    from repro_torch.kernels.flash_attention import backward as bmod
    b, hq, hkv, sq, sk, d, causal, window = FLASH_BWD_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(7)
    before = dict(bmod.LAUNCHES_BY_ROUTE)
    errs, (q, *_) = cs.flash_bwd_check(cuda, g, name, b, hq, hkv, sq, sk,
                                       d, dtype, causal, window)
    assert max(errs[w] for w in ("dq", "dk", "dv")) <= \
        cs.FLASH_BWD_REL_TOL[str(dtype)]
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "simt"
    assert errs["route"] == want == bmod.route(dtype, d, cuda)
    assert {r: n - before[r] for r, n in bmod.LAUNCHES_BY_ROUTE.items()} \
        == {r: 2 * (r == want) for r in before}


def test_flash_attention_returns_grad_fn_and_kernel_gradients(cuda):
    """On CUDA tensors requiring grad, flash attention goes through the
    autograd Function: a ``grad_fn``, one forward and one backward launch,
    the gradients of the plain version; under no_grad a serving call
    moves only the forward's counter."""
    from repro_torch.kernels.flash_attention import backward as bmod
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(s, device=cuda, generator=g)
               for s in ((2, 8, 96, 64), (2, 2, 96, 64), (2, 2, 96, 64)))
    do = torch.randn((2, 8, 96, 64), device=cuda, generator=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fmod.reset_launches()
    bmod.reset_launches()
    out = flash_attention(*leaves, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    assert fmod.LAUNCHES == 1 and bmod.LAUNCHES == 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention_plain(*(t.reshape(-1, 96, 64) for t in plain),
                              group=4).reshape(2, 8, 96, 64)
    want = torch.autograd.grad(o, plain, do)
    for a, w in zip(got, want):
        assert cs.rel_rms(a, w) < cs.FLASH_BWD_REL_TOL["torch.float32"]
    with torch.no_grad():
        assert flash_attention(*leaves).grad_fn is None
    assert fmod.LAUNCHES == 2 and bmod.LAUNCHES == 1


def test_rmsnorm_kernel_raises_where_grads_are_taken(cuda):
    """A kernel with no backward raises on a CUDA input requiring grad in
    grad mode, naming its ROADMAP item, and runs under no_grad."""
    x = torch.randn((4, 64), device=cuda, requires_grad=True)
    w = torch.ones(64, device=cuda)
    with pytest.raises(RuntimeError, match="ROADMAP Queue 1, item 23"):
        rmsnorm(x, w)
    with torch.no_grad():
        assert rmsnorm(x, w).shape == (4, 64)


def test_ssm_kernel_takes_gradients_through_its_backward(cuda):
    """Where an input requires grad the fused op goes through ``SSMScan``:
    one forward launch on the chunked route (at T = 1 too), one backward
    launch, and the plain version's gradients; under no_grad no Function.
    The kernel's wrapper alone refuses such inputs."""
    from repro_torch.kernels.ssm_scan import backward as sbmod
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_fused
    n, d = 4, 32
    for t in (1, 8, 300):
        g = torch.Generator(device=cuda).manual_seed(t)
        args = [torch.randn((1, t, d), device=cuda, generator=g),
                torch.randn((d, 2 * n + 1), device=cuda, generator=g) / 6,
                torch.randn(d, device=cuda, generator=g) * 0.3,
                torch.randn((d, n), device=cuda, generator=g) * 0.2,
                torch.randn((1, d, n), device=cuda, generator=g) * 0.3]
        dy = torch.randn((1, t, d), device=cuda, generator=g)
        leaves = [a.clone().requires_grad_() for a in args]
        smod.reset_launches()
        sbmod.reset_launches()
        with pytest.raises(RuntimeError, match="ssm_scan_fused"):
            smod.ssm_scan_kernel(*leaves)
        y, _ = ssm_scan_fused(*leaves)
        assert type(y.grad_fn).__name__ == "SSMScanBackward"
        got = torch.autograd.grad(y, leaves, dy)
        assert smod.LAUNCHES_BY_ROUTE == {"chunked": 1, "step": 0}
        assert sbmod.LAUNCHES_BY_ROUTE == {"scan": 1}
        plain = [a.clone().requires_grad_() for a in args]
        want = torch.autograd.grad(ssm_scan_ref(*plain)[0], plain, dy)
        for a, w in zip(got, want):
            assert cs.rel_rms(a, w) < cs.SSM_BWD_REL_TOL["torch.float32"]
        with torch.no_grad():
            assert ssm_scan_fused(*leaves)[0].grad_fn is None


SSM_BWD_CASES = {
    # b, t, d, n, carried h0 and dh
    "hymba training": (4, 2048, 1600, 16, False),
    "hymba training, carried": (4, 2048, 1600, 16, True),
    "T=1": (2, 1, 1600, 16, True),
    "T=130": (2, 130, 1600, 16, True),
    "T=2065 (a short last chunk)": (2, 2065, 256, 16, True),
    "d=1001, n=5": (3, 300, 1001, 5, True),
    "T=255 (two spans less a step)": (2, 255, 1600, 16, True),
    "T=257 (two spans and a step)": (2, 257, 1600, 16, True),
    "d=200, n=8 (not a multiple of the channel group)": (2, 300, 200, 8,
                                                         True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(SSM_BWD_CASES))
def test_ssm_backward_kernel_matches_plain_version(cuda, name, dtype):
    """``chip_smoke.ssm_bwd_check``: the forward saving its states, two
    backward launches giving the same bytes, each gradient within
    ``SSM_BWD_REL_TOL`` relative RMS of the plain backward in f32."""
    g = torch.Generator(device=cuda).manual_seed(19)
    b, t, d, n, carried = SSM_BWD_CASES[name]
    errs, _ = cs.ssm_bwd_check(cuda, g, name, b, t, d, n, dtype, carried)
    assert max(errs[k] for k in cs.SSM_GRADS) <= \
        cs.SSM_BWD_REL_TOL[str(dtype)]


def test_ssm_backward_scan_matches_the_first_design(cuda):
    """At hymba's training shape in bf16 (h0 and dh zero, as in training)
    the scan route and the first design (``backward.rerun_launch``, the
    chunks re-run through device memory) agree within the bf16 tolerance;
    the first design counts no launch."""
    from repro_torch.kernels.ssm_scan import backward as sbmod
    g = torch.Generator(device=cuda).manual_seed(21)
    _, inputs = cs.ssm_bwd_check(cuda, g, "hymba training bf16", 4, 2048,
                                 1600, 16, torch.bfloat16, False)
    new = sbmod.ssm_scan_bwd_kernel(*inputs)
    before = sbmod.LAUNCHES
    old = sbmod.rerun_launch(*inputs)
    assert sbmod.LAUNCHES == before
    errs, _ = cs.grad_errors("scan vs the first design", new, old,
                             cs.SSM_BWD_REL_TOL["torch.bfloat16"])
    assert max(errs.values()) <= cs.SSM_BWD_REL_TOL["torch.bfloat16"]


def test_ssm_backward_gradients_stay_finite_where_a_underflows(cuda):
    """dt past softplus's threshold and a = exp(-A dt) underflowing to 0:
    every gradient finite and held to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(20)
    for name, shifts in (("dt past 20", {"dt_shift": 25.0}),
                         ("a underflows", {"dt_shift": 3.0,
                                           "a_shift": 6.0})):
        cs.ssm_bwd_check(cuda, g, name, 2, 300, 80, 16, torch.float32,
                         True, **shifts)


def test_hymba_train_step_launches_both_ssm_kernels(cuda):
    """One step of hymba's smoke widths (f32, attn_impl "ref") on the card
    with remat on: per layer two SSM launches on the chunked route (the
    forward and the recompute) and one backward launch on the scan route;
    every leaf gets a gradient, and the step's loss and gradient norm
    equal the same step on the CPU (the reference's chunked scan) from the
    same weights within 1e-4 of themselves."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ssm_scan import backward as sbmod
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, named_tree
    from repro_torch.optim.schedule import constant
    from repro_torch.train import (StepConfig, init_train_state,
                                   make_train_step)
    cfg = get_smoke_config("hymba-1.5b").scaled(remat=True)
    metrics, weights = {}, None
    for dev in (torch.device("cpu"), cuda):
        model = build_model(cfg, device=dev)
        seen = []
        opt = cs.grads_checked(adamw(), seen)
        state = init_train_state(model, opt, 0)
        named = named_tree(state.params)
        if weights is None:
            weights = {k: v.detach().clone() for k, v in named.items()}
        with torch.no_grad():
            for k, v in named.items():
                v.copy_(weights[k])
        step = make_train_step(model, opt, constant(1e-3), StepConfig())
        batch = train.make_batch_fn(cfg, 2, 300, 0, dev)(0)
        smod.reset_launches()
        sbmod.reset_launches()
        state, metrics[dev.type] = step(state, batch)
        assert all(seen[0].values()) and len(seen[0]) == len(named)
    assert smod.LAUNCHES_BY_ROUTE == {"chunked": 2 * cfg.num_layers,
                                      "step": 0}
    assert sbmod.LAUNCHES == cfg.num_layers
    assert sbmod.LAUNCHES_BY_ROUTE == {"scan": cfg.num_layers}
    for k in ("loss", "grad_norm"):
        a, b = (float(metrics[x][k]) for x in ("cuda", "cpu"))
        assert np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b), (k, a, b)


def test_llama_train_step_launches_flash_and_its_backward(cuda):
    """One step of the 2-layer Llama smoke widths on the card at head dim
    64 in bf16: with remat, two forward launches and one backward launch
    a layer, all on the wgmma route; every leaf gets a gradient."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import backward as bmod
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import constant
    from repro_torch.train import (StepConfig, init_train_state,
                                   make_train_step)
    cfg = get_smoke_config("llama3.2-1b").scaled(
        dtype="bfloat16", remat=True, attn_impl="auto", head_dim=64,
        num_heads=4, num_kv_heads=2, d_model=128)
    model = build_model(cfg, device=cuda)
    seen = []
    opt = cs.grads_checked(adamw(), seen)
    state = init_train_state(model, opt, 0)
    step = make_train_step(model, opt, constant(1e-3), StepConfig())
    batch = train.make_batch_fn(cfg, 2, 128, 0, cuda)(0)
    fmod.reset_launches()
    bmod.reset_launches()
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert fmod.LAUNCHES_BY_ROUTE == {"wgmma": 2 * cfg.num_layers,
                                      "simt": 0}
    assert bmod.LAUNCHES == cfg.num_layers
    assert bmod.LAUNCHES_BY_ROUTE == {"wgmma": cfg.num_layers, "simt": 0}
    assert all(seen[0].values()) and len(seen[0]) == len(
        list(state.params.parameters()))


def test_mesh_cp_prefill_launches_the_scan_twice_a_shard(cuda):
    """chip_smoke's slice 10a at hymba's smoke widths (f32, flash on the
    card): the context-parallel prefill on a (data 1, model 4) mesh
    launches the scan's chunked route twice a shard a layer, returns zero
    SSM states, and its logits lie within 1% of the largest |logit| of
    the plain prefill's."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("hymba-1.5b").scaled(attn_impl="auto")
    out = cs.cp_prefill_path(0, cfg=cfg, batch=2, prompt=256,
                             mesh_spec=((1, 4), ("data", "model")))
    assert out["ssm_scan_launches"] == 2 * 4 * cfg.num_layers
    assert out["f32_max_abs_diff"] <= cs.SSM_ROUTE_TOL_FRAC * \
        out["max_abs_logit"]


def test_mesh_ep_prefill_matches_dense_without_drops(cuda):
    """chip_smoke's slice 10b at granite's smoke widths (f32): on a (data
    2, model 2) mesh both expert-parallel layouts launch no dispatch
    kernel, drop nothing at capacity factor 8 and give the dense path's
    logits within 1e-4 of the largest |logit|; at the config's 1.25 they
    count their drops alike."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("granite-moe-1b-a400m").scaled(attn_impl="auto")
    out = cs.ep_prefill_path(0, cfg=cfg, batch=4, prompt=64,
                             mesh_spec=((2, 2), ("data", "model")),
                             tol_frac=1e-4)
    runs = out["runs"]
    assert all(runs[f"{m} cf {cs.EP_NO_DROP_CF}"]["dropped"] == 0
               for m in cs.MOE_MODES)
    cf = cfg.capacity_factor
    assert runs[f"weight_gather cf {cf}"]["dropped"] == \
        runs[f"token_gather cf {cf}"]["dropped"]


def test_mesh_grad_syncs_match_the_fused_step(cuda):
    """chip_smoke's slice 10c at Llama's smoke widths (f32, flash and its
    backward on the card): one step of ``mare_tree`` at depths 1-3, with
    the int8 codec and ``hierarchical``, each shard launching flash and
    its backward once a layer, the losses within 1e-3 of the fused
    step's, the gradients handed to AdamW and their norm within 1e-5 of
    the fused step's (the codec's of its plain version), and the
    parameters within 1e-5 of the fused step's where its gradient is at
    or above 1e-6 and of the one-at-a-time fused step's everywhere."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import init_train_state
    cfg = get_smoke_config("llama3.2-1b").scaled(attn_impl="auto")
    model = build_model(cfg, device=cuda)
    opt = adamw()
    state = init_train_state(model, opt, 0)
    batch = train.make_batch_fn(cfg, 4, 64, 0, cuda)(0)
    res = cs.sync_steps("smoke", model, opt, state, batch, param_check=True)
    assert set(res) == {"fused", "fused one at a time"} | \
        {s[0] for s in cs.SYNCS}
    exact = [r for name, r in res.items()
             if name not in ("fused", "fused one at a time",
                             "mare_tree depth 2 int8")]
    assert all(r["params_vs_fused"]["above_floor"] <= cs.SYNC_PARAM_TOL and
               r["params_vs_one_at_a_time"] <= cs.SYNC_PARAM_TOL and
               r["grad_rel_diff"] <= 1e-5 for r in exact)
    assert res["mare_tree depth 2 int8"]["grads_held_to"] == "plain int8"
