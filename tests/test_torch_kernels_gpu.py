"""On the card: each CUDA kernel (segment sum, flash attention, RMSNorm,
MoE dispatch, top-k, selective scan) against its plain version, the k-mer
and virtual-screening paths on ``cuda`` against the same paths on the
CPU, and the launches of the LM prefill (flash), the MoE layers
(dispatch) and the hybrid layers (selective scan).

Every test here needs a CUDA device: it is marked ``gpu`` and skips
without one.  This file imports no JAX, so it runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
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
}


def _case(seed, n, num_keys, hot=None, valid_frac=0.8):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-3, num_keys + 5, size=n).astype(np.int32)
    if hot is not None:
        keys[rng.random(n) < 0.9] = hot
    valid = rng.random(n) < valid_frac
    ints = rng.integers(-50, 100, size=(n, 3)).astype(np.int32)
    floats = rng.normal(size=(n, 2)).astype(np.float32)
    floats[~valid] = np.nan            # padding may hold NaN
    return keys, valid, ints, floats


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name):
    c = CASES[name]
    keys, valid, ints, floats = _case(6, **c)
    k = torch.from_numpy(keys).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    before = kmod.LAUNCHES
    for vals in (ints, floats):
        vals = torch.from_numpy(vals).to(cuda)
        got = segment_sum(k, vals, c["num_keys"], v)
        torch.cuda.synchronize()
        want = segment_sum_ref(k, vals, c["num_keys"], v)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.device == b.device
        # counts and overflow are int32 in both cases: exact
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        if vals.dtype == torch.int32:
            assert torch.equal(got[0], want[0])
        else:
            # atomics add in another order: hold the table to the plain
            # version in float64, atol tied to the largest per-key count
            # and the largest valid value
            want64 = segment_sum_ref(k, vals.double(), c["num_keys"], v)[0]
            vmax = float(vals[v].abs().max()) if bool(v.any()) else 0.0
            atol = 1e-6 * int(want[1].max()) * vmax
            torch.testing.assert_close(got[0].double(), want64, rtol=1e-5,
                                       atol=atol)
    assert kmod.LAUNCHES - before == (2 if c["n"] else 0)


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
}
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
    before = fmod.LAUNCHES
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fmod.LAUNCHES - before == 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(
        q.float().reshape(b * hq, sq, d), k.float().reshape(b * hkv, sk, d),
        v.float().reshape(b * hkv, sk, d), hq // hkv, causal=causal,
        window=window).reshape(b, hq, sq, d)
    err = float((got.float() - want).abs().max())
    assert err < FLASH_TOL[dtype], (name, dtype, err)
    if sq > sk and causal:
        # queries right-aligned past the keys see none: exactly 0
        assert bool((got[:, :, :sq - sk] == 0).all())


def test_flash_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.zeros((2, 8, 24), device=cuda)
    with pytest.raises(ValueError):
        fmod.flash_attention_kernel(q, q, q, group=1)


RMS_SHAPES = [(8192, 2048), (4, 2048), (33, 100), (7, 1000), (1, 8)]


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
    before = rmod.LAUNCHES
    got = rmsnorm(x, w, eps=1e-6)
    torch.cuda.synchronize()
    assert rmod.LAUNCHES - before == 1
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
    one flash launch per layer and no RMSNorm launch (the model's norms
    take the plain version, as the reference's do), and its logits agree
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
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, 208)
        torch.cuda.synchronize()
        assert fmod.LAUNCHES - f0 == 2 and rmod.LAUNCHES == r0
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
    # name: (b, t, d, n, carried h0)
    "hymba_prefill": (4, 2048, 1600, 16, False),
    "hymba_decode": (4, 1, 1600, 16, True),
    "odd_t_33": (2, 33, 64, 16, True),
    "odd_t_100": (1, 100, 48, 8, True),
    "odd_d": (3, 50, 1001, 16, False),
    "n2": (2, 40, 37, 2, True),
    "n4": (2, 40, 37, 4, True),
    "n5": (1, 17, 9, 5, True),
    "n8": (2, 40, 37, 8, True),
    "n32": (1, 20, 40, 32, True),
}
# chip_smoke.ssm_compare holds y (and h) within 1e-3 of the largest
# magnitude: both versions accumulate in f32, in another order


def ssm_inputs(dev, seed, b, t, d, n, dtype, carried=True):
    """``chip_smoke.ssm_inputs`` from a seeded generator: inputs shaped
    like the model's."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return cs.ssm_inputs(dev, g, b, t, d, n, dtype, carried)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(SSM_CASES))
def test_ssm_kernel_matches_plain_version(cuda, name, dtype):
    b, t, d, n, carried = SSM_CASES[name]
    args = ssm_inputs(cuda, 13, b, t, d, n, dtype, carried)
    before = smod.LAUNCHES
    got = smod.ssm_scan_kernel(*args)
    torch.cuda.synchronize()
    assert smod.LAUNCHES - before == 1
    cs.ssm_compare(name, got, ssm_scan_ref(*args))


def test_ssm_kernel_halves_chain_to_one_pass(cuda):
    xc, x_proj, dt_bias, a_log, h0 = ssm_inputs(cuda, 14, 2, 300, 96, 16,
                                                torch.bfloat16)
    y, h = ssm_scan_fused(xc, x_proj, dt_bias, a_log, h0)
    y1, h1 = ssm_scan_fused(xc[:, :137], x_proj, dt_bias, a_log, h0)
    y2, h2 = ssm_scan_fused(xc[:, 137:], x_proj, dt_bias, a_log, h1)
    cs.ssm_compare("chained", (torch.cat([y1, y2], 1), h2), (y, h))


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
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": toks}, 1104)
        torch.cuda.synchronize()
        assert smod.LAUNCHES - s0 == 2 and fmod.LAUNCHES - f0 == 2
        lg, caches = model.decode_step(params, caches, toks[:, -1])
        assert smod.LAUNCHES - s0 == 4 and fmod.LAUNCHES - f0 == 2
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
