"""On the card: the selective scan's dt route with the mixer's gate, and
the mixer's conv kernel, against their plain versions; the mixer's
passes over [S, d_inner] under the profiler; a request's launches; and
the Jamba stack on the kernels against the same stack on the CPU.

Every test here needs a CUDA device: it is marked ``gpu`` and skips
without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_jamba_gpu.py
"""
import math

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.mamba_conv import kernel as cmod
from repro_torch.kernels.mamba_conv import mamba_conv_ref
from repro_torch.kernels.ssm_scan import kernel as smod
from repro_torch.kernels.ssm_scan import ssm_scan_dt_ref
from repro_torch.models import build_model
from repro_torch.models import ssm as ssm_lib

#: The scan's own limit (its exp2 on the MUFU, relative ~2^-22, and its
#: order of sums), of the largest |value|: y's, h's.
SCAN_TOL = 1e-3
#: The gated out in bfloat16: y + d_skip u and the product are each
#: rounded once, so a y within SCAN_TOL can land one bfloat16 ulp away
#: (2^-7 of the largest |out| at most) at each.
GATE_TOL_BF16 = SCAN_TOL + 2 * 2 ** -7

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(dev, b, t, d, n, dtype, seed=0):
    """u, dt, dt_bias, B, C, a_log, h0, then the gate z (the second half
    of a [b, t, 2d] tensor, as the mixer's) and d_skip."""
    g = torch.Generator(device=dev).manual_seed(seed)
    step = torch.exp(torch.rand((d,), generator=g, device=dev) * 4.6 - 6.9)
    return (torch.randn((b, t, d), generator=g, device=dev).to(dtype),
            torch.randn((b, t, d), generator=g, device=dev).to(dtype),
            step + torch.log(-torch.expm1(-step)),
            torch.randn((b, t, n), generator=g, device=dev).to(dtype),
            torch.randn((b, t, n), generator=g, device=dev).to(dtype),
            torch.log(torch.arange(1, n + 1.0, device=dev)).repeat(d, 1),
            torch.randn((b, d, n), generator=g, device=dev) * 0.5,
            torch.randn((b, t, 2 * d), generator=g, device=dev)
            .to(dtype)[..., d:],
            1.0 + 0.5 * torch.randn((d,), generator=g, device=dev))


def frac_of_max(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


# (b, t, d, n, dtype, route): Jamba's widths, the chunk's edges, n off
# the slot sizes, the largest state
CASES = [(1, 300, 8192, 16, torch.bfloat16, "chunked"),
         (1, 1, 8192, 16, torch.bfloat16, "step"),
         (2, 128, 300, 16, torch.float32, "chunked"),
         (2, 129, 300, 16, torch.float32, "chunked"),
         (3, 257, 1000, 5, torch.float32, "chunked"),
         (3, 1, 1000, 5, torch.float32, "step"),
         (1, 140, 256, 32, torch.bfloat16, "chunked"),
         (1, 2, 64, 4, torch.float32, "chunked")]


@pytest.mark.parametrize("b,t,d,n,dtype,route", CASES)
def test_dt_route_against_plain(dev, b, t, d, n, dtype, route):
    args = inputs(dev, b, t, d, n, dtype)
    before = dict(smod.DT_LAUNCHES_BY_ROUTE)
    fused = smod.LAUNCHES
    out, h = smod.ssm_scan_dt_kernel(*args)
    torch.cuda.synchronize()
    moved = {k: smod.DT_LAUNCHES_BY_ROUTE[k] - before[k] for k in before}
    assert moved == {k: int(k == route) for k in before}
    assert smod.LAUNCHES == fused
    assert out.dtype == dtype
    # the plain version in the same roundings, on the card
    ro, rh = ssm_scan_dt_ref(*args)
    tol = GATE_TOL_BF16 if dtype == torch.bfloat16 else SCAN_TOL
    assert frac_of_max(out, ro) < tol
    assert frac_of_max(h, rh) < SCAN_TOL


def test_jamba_on_the_card_against_the_cpu(dev):
    cfg = get_smoke_config("jamba2-mini").scaled(attn_impl="auto")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(0)
    card = build_model(cfg, device=dev)
    params_card = card.init(0)
    params_card.load_state_dict(params.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (1, 200),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, cache = cpu.prefill(params, {"tokens": tokens}, 204)
        got, cache_d = card.prefill(params_card, {"tokens": tokens.to(dev)},
                                    204)
        rows_w, rows_g = [want[:, -1]], [got[:, -1]]
        for t in range(4):
            tok = tokens[:, t]
            lw, cache = cpu.decode_step(params, cache, tok)
            lg, cache_d = card.decode_step(params_card, cache_d, tok.to(dev))
            rows_w.append(lw)
            rows_g.append(lg)
    w, g = torch.stack(rows_w), torch.stack(rows_g).cpu()
    # float32 on both; the card's flash (its simt route in float32) and
    # scan sum in other orders
    assert float((g - w).abs().max() / w.abs().max()) < 1e-3


def conv_inputs(dev, b, t, d, k, dtype, carried, seed=0):
    """xi (the first half of a [b, t, 2d] in-projection output), conv_w,
    conv_b and the window (carried rows, or zeros as a prefill's)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xz = torch.randn((b, t, 2 * d), generator=g, device=dev).to(dtype)
    win = (torch.randn((b, k - 1, d), generator=g, device=dev) if carried
           else torch.zeros((b, k - 1, d), device=dev)).to(dtype)
    return (xz[..., :d],
            (0.5 * torch.randn((k, d), generator=g, device=dev)).to(dtype),
            (0.5 * torch.randn((d,), generator=g, device=dev)).to(dtype),
            win)


# (b, t, d, k, dtype): Jamba's widths at a decode step, odd T, a 4,096 and
# the 65,536-step prefill; float32; T below K-1 and a partial last step
# tile over several batch rows; the smoke config's widths
CONV_CASES = [(1, 1, 8192, 4, torch.bfloat16),
              (1, 7, 8192, 4, torch.bfloat16),
              (1, 4096, 8192, 4, torch.bfloat16),
              (1, 65536, 8192, 4, torch.bfloat16),
              (2, 300, 1024, 4, torch.float32),
              (3, 130, 1000, 4, torch.bfloat16),
              (2, 2, 64, 4, torch.bfloat16),
              (2, 70, 128, 4, torch.float32)]


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("b,t,d,k,dtype", CONV_CASES)
def test_mamba_conv_against_plain(dev, b, t, d, k, dtype, carried):
    """u and the new window against the plain version (the mixer's conv
    as it was) on the card: within one ulp of their type, the window bit
    for bit; the share of u's elements that are bit-equal is printed."""
    xi, w, cb, win = conv_inputs(dev, b, t, d, k, dtype, carried)
    route = "step" if t == 1 else "chunked"
    before = dict(cmod.LAUNCHES_BY_ROUTE)
    u, new = cmod.mamba_conv(xi, w, cb, win)
    torch.cuda.synchronize()
    moved = {r: cmod.LAUNCHES_BY_ROUTE[r] - before[r] for r in before}
    assert moved == {r: int(r == route) for r in before}
    ru, rnew = mamba_conv_ref(xi, w, cb, win)
    assert u.dtype == dtype and torch.equal(new, rnew)
    # one ulp of the type at each element: |want| in [2^(e-1), 2^e) has
    # spacing 2^(e-1-p), p the stored mantissa bits
    p_bits = 7 if dtype == torch.bfloat16 else 23
    _, e = torch.frexp(ru.float())
    ulp = torch.ldexp(torch.ones_like(ru, dtype=torch.float32),
                      e - 1 - p_bits)
    diff = (u.float() - ru.float()).abs()
    assert bool((diff <= ulp).all()), float((diff - ulp).max())
    print(f"conv b={b} t={t} d={d} k={k} {dtype} carried={carried}: "
          f"bit-equal {float((u == ru).float().mean()):.6f}")


@pytest.mark.parametrize("t", [4096, 1])
def test_mixer_runs_no_elementwise_pass_over_its_rows(dev, t):
    """One Mamba mixer call at Jamba's widths under torch.profiler: every
    pass over [S, d_inner] (or [S, 2 d_inner]) is a GEMM, the conv kernel
    or the scan's; no elementwise kernel reads such a tensor."""
    cfg = get_config("jamba2-mini").scaled(num_layers=1)
    p = build_model(cfg, device=dev).init(0).blocks[0].mamba
    x = torch.randn((1, t, cfg.d_model), device=dev).to(cfg.param_dtype)
    di = cfg.d_model * cfg.ssm_expand
    state = ssm_lib.init_ssm_state(cfg, 1, device=dev) if t == 1 else None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        ssm_lib.mamba_mixer(p, x, cfg, state)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts,
                                    record_shapes=True) as prof:
            ssm_lib.mamba_mixer(p, x, cfg, state)
            torch.cuda.synchronize()
    big, names = [], set()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names.add(e.name)
            continue
        kernels = [k.name for k in e.kernels]
        sizes = [math.prod(s) for s in (e.input_shapes or []) if s]
        if any(n >= t * di for n in sizes) and any(
                "elementwise" in k for k in kernels):
            big.append((e.name, e.input_shapes, kernels))
    assert not big, big
    # names as the trace gives them: "(anonymous namespace)::<kernel><...>"
    assert any("::mamba_conv_silu<" in k for k in names), sorted(names)
    scan = "ssm_dt_step" if t == 1 else "ssm_dt_chunk_scan"
    assert any(f"::{scan}<" in k for k in names), sorted(names)


def test_request_launches(dev):
    """A benchmark-shaped request (a prompt, then 16 greedy decode steps)
    on a bfloat16 Jamba period: 7 conv and 7 gated scan launches on
    ``chunked`` in the prefill, 112 of each on ``step`` in the decode."""
    from repro_torch.launch.serve import greedy_request
    cfg = get_smoke_config("jamba2-mini").scaled(dtype="bfloat16")
    model = build_model(cfg, device=dev)
    params = model.init(0)
    ids = torch.randint(0, cfg.vocab_size, (1, 300), device=dev)
    cmod.reset_launches()
    smod.reset_launches()
    with torch.no_grad():
        greedy_request(model, params, ids, 16)
    torch.cuda.synchronize()
    assert (cmod.LAUNCHES, cmod.LAUNCHES_BY_ROUTE) == (
        119, {"chunked": 7, "step": 112})
    assert (smod.DT_LAUNCHES, smod.DT_LAUNCHES_BY_ROUTE) == (
        119, {"chunked": 7, "step": 112})
    assert smod.LAUNCHES == 0


@pytest.mark.parametrize("case", ["d", "row stride", "taps"])
def test_mamba_conv_refuses_what_it_cannot_load(dev, case):
    """The kernel loads 16 bytes a thread over K = 4 taps: a width or row
    stride off the pack, or another K, raises before any launch."""
    d = {"d": 1001, "row stride": 1000, "taps": 64}[case]
    xi, w, cb, win = conv_inputs(dev, 1, 9, d, 4, torch.bfloat16, True)
    if case == "row stride":
        xi = torch.randn((1, 9, 2 * d + 2), device=dev).bfloat16()[..., :d]
    if case == "taps":
        w, win = w[:3].contiguous(), win[:, :2].contiguous()
    before = cmod.LAUNCHES
    with pytest.raises(ValueError):
        cmod.mamba_conv(xi, w, cb, win)
    assert cmod.LAUNCHES == before
