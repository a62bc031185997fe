"""On the card: the selective scan's dt route against its plain version,
and the Jamba stack on the kernels against the same stack on the CPU.

Every test here needs a CUDA device: it is marked ``gpu`` and skips
without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_jamba_gpu.py
"""
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssm_scan import kernel as smod
from repro_torch.kernels.ssm_scan import ssm_scan_dt_ref
from repro_torch.models import build_model

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(dev, b, t, d, n, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    step = torch.exp(torch.rand((d,), generator=g, device=dev) * 4.6 - 6.9)
    return (torch.randn((b, t, d), generator=g, device=dev).to(dtype),
            torch.randn((b, t, d), generator=g, device=dev).to(dtype),
            step + torch.log(-torch.expm1(-step)),
            torch.randn((b, t, n), generator=g, device=dev).to(dtype),
            torch.randn((b, t, n), generator=g, device=dev).to(dtype),
            torch.log(torch.arange(1, n + 1.0, device=dev)).repeat(d, 1),
            torch.randn((b, d, n), generator=g, device=dev) * 0.5)


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
    y, h = smod.ssm_scan_dt_kernel(*args)
    torch.cuda.synchronize()
    moved = {k: smod.DT_LAUNCHES_BY_ROUTE[k] - before[k] for k in before}
    assert moved == {k: int(k == route) for k in before}
    assert smod.LAUNCHES == fused
    ry, rh = ssm_scan_dt_ref(*(a.float() for a in args))
    # the kernel's exp2 on the MUFU (relative ~2^-22) and its order of sums
    assert float((y - ry).abs().max() / ry.abs().max()) < 1e-3
    assert float((h - rh).abs().max() / rh.abs().max()) < 1e-3


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
