"""Which kernel a call takes, decided from dtype, head dim (or row width)
and device alone, on the CPU: the flash wrapper's routes (``wgmma`` for
bf16 at head dims 64 and 128, ``simt`` for every other CUDA call, the
plain version for a CPU tensor) and RMSNorm's paths (one pass where the
row fits in registers, else the two-pass loop).  A CPU call moves no
launch counter; the wrappers' argument checks raise before any route is
taken.  The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``)."""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fmod
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.rmsnorm import kernel as rmod
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

BF16, F32 = torch.bfloat16, torch.float32
CUDA = torch.device("cuda")   # a device name only: no card is touched

FLASH_ROUTES = [
    # dtype, head dim, device, route
    (BF16, 64, CUDA, "wgmma"),
    (BF16, 128, CUDA, "wgmma"),
    (BF16, 16, CUDA, "simt"),
    (BF16, 32, CUDA, "simt"),
    (BF16, 96, CUDA, "simt"),
    (F32, 64, CUDA, "simt"),
    (F32, 128, CUDA, "simt"),
    (F32, 16, CUDA, "simt"),
    (BF16, 64, "cpu", "plain"),
    (F32, 64, "cpu", "plain"),
    (BF16, 128, torch.device("cpu"), "plain"),
]


@pytest.mark.parametrize("dtype,d,device,want", FLASH_ROUTES, ids=str)
def test_flash_route_is_a_function_of_dtype_head_dim_device(dtype, d,
                                                            device, want):
    assert fmod.route(dtype, d, device) == want


def _qkv(dtype, b=2, hkv=2, group=2, sq=40, sk=40, d=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b * hkv * group, sq, d), generator=g).to(dtype)
    k = torch.randn((b * hkv, sk, d), generator=g).to(dtype)
    v = torch.randn((b * hkv, sk, d), generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128, 32])
def test_cpu_tensor_takes_plain_version_and_moves_no_counter(dtype, d):
    q, k, v = _qkv(dtype, d=d)
    total = fmod.LAUNCHES
    by_route = dict(fmod.LAUNCHES_BY_ROUTE)
    got = fmod.flash_attention_kernel(q, k, v, group=2, causal=True,
                                      window=16)
    assert fmod.LAUNCHES == total
    assert fmod.LAUNCHES_BY_ROUTE == by_route
    want = flash_attention_plain(q, k, v, 2, causal=True, window=16)
    assert got.dtype == dtype and torch.equal(got, want)


def test_reset_launches_zeroes_every_route():
    fmod.LAUNCHES_BY_ROUTE["wgmma"] += 3
    fmod.LAUNCHES_BY_ROUTE["simt"] += 1
    fmod.LAUNCHES += 4
    fmod.reset_launches()
    assert fmod.LAUNCHES == 0
    assert fmod.LAUNCHES_BY_ROUTE == {"wgmma": 0, "simt": 0}


@pytest.mark.parametrize("shapes,group", [
    (((8, 40, 64), (4, 40, 64), (4, 40, 64)), 3),   # 8 != 4 * 3
    (((8, 40, 64), (4, 40, 64), (4, 41, 64)), 2),   # k and v differ
    (((8, 40, 64), (4, 40, 32), (4, 40, 32)), 2),   # head dims differ
    (((8, 40), (4, 40), (4, 40)), 2),               # not 3-D
], ids=["group", "k_vs_v", "head_dim", "rank"])
def test_flash_wrapper_checks_shapes_first(shapes, group):
    q, k, v = (torch.zeros(s) for s in shapes)
    before = fmod.LAUNCHES
    with pytest.raises(ValueError):
        fmod.flash_attention_kernel(q, k, v, group=group)
    assert fmod.LAUNCHES == before


def test_flash_wrapper_rejects_mixed_and_foreign_devices():
    q, k, v = _qkv(F32)
    with pytest.raises(ValueError):
        fmod.flash_attention_kernel(q, k.to("meta"), v, group=2)
    with pytest.raises(ValueError):          # neither cpu nor cuda
        fmod.flash_attention_kernel(q.to("meta"), k.to("meta"),
                                    v.to("meta"), group=2)


RMS_PATHS = [
    # width, dtype, aligned, path
    (2048, BF16, True, "one_pass"),     # Llama: 8 packs a lane
    (1600, BF16, True, "one_pass"),     # hymba: 200 packs, 7 or 6 a lane
    (8192, BF16, True, "one_pass"),     # 1,024 packs over 128 threads
    (8200, BF16, True, "loop16"),       # 1,025 packs: past the registers
    (2050, BF16, True, "loop"),         # not whole 16-byte packs
    (100, BF16, True, "loop"),
    (2048, BF16, False, "loop"),        # a pointer off 16 bytes
    (2048, F32, True, "one_pass"),
    (4096, F32, True, "one_pass"),
    (8192, F32, True, "loop16"),
    (1000, F32, True, "one_pass"),
    (1002, F32, True, "loop"),
]


@pytest.mark.parametrize("d,dtype,aligned,want", RMS_PATHS, ids=str)
def test_rmsnorm_path_is_a_function_of_width_dtype_alignment(d, dtype,
                                                             aligned, want):
    assert rmod.path(d, dtype, aligned) == want


def test_rmsnorm_cpu_tensor_takes_plain_version_and_moves_no_counter():
    g = torch.Generator().manual_seed(1)
    x = torch.randn((16, 1600), generator=g).to(BF16)
    w = (1 + 0.1 * torch.randn(1600, generator=g)).to(BF16)
    total, by_path = rmod.LAUNCHES, dict(rmod.LAUNCHES_BY_PATH)
    got = rmod.rmsnorm_kernel(x, w, 1e-6)
    assert rmod.LAUNCHES == total and rmod.LAUNCHES_BY_PATH == by_path
    assert torch.equal(got, rmsnorm_ref(x, w, 1e-6))


def test_rmsnorm_reset_launches_zeroes_every_path():
    rmod.LAUNCHES_BY_PATH["one_pass"] += 2
    rmod.LAUNCHES += 2
    rmod.reset_launches()
    assert rmod.LAUNCHES == 0
    assert set(rmod.LAUNCHES_BY_PATH.values()) == {0}
