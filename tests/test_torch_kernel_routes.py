"""Which kernel a call takes, decided from dtype, head dim (or row width,
or steps) and device alone, on the CPU: the flash wrapper's routes
(``wgmma`` for bf16 at head dims 64 and 128, ``simt`` for every other
CUDA call, the plain version for a CPU tensor), RMSNorm's paths (one pass
where the row fits in registers, else the two-pass loop) and the
selective scan's routes (``step`` for a decode step, T = 1; ``chunked``
for T > 1; the plain version for a CPU tensor) and the segment sum's
(``binned`` for one to three value columns over a key space it can
tile, ``atomic`` otherwise, from the key space, the value columns and
the record count alone), the exchange's (``hash`` for keys, ``dests``
for given destinations, from the device alone), the MoE dispatch's
(``cluster`` up to the cluster's reach of ids over at most
``CLUSTER_GROUPS`` groups, ``tiled`` otherwise, from n and the group
count alone) and the top-k's (``select``
for k <= 32, ``tree`` otherwise, from k alone).  A CPU call moves no
launch counter; the wrappers' argument checks raise before any route is
taken, and a device other than cpu, cuda and meta (the dry run's, which
has a route of its own: ``tests/test_torch_hlo_cost.py``) raises.  The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``)."""
import pytest
import torch

from repro_torch.kernels.exchange import kernel as xmod
from repro_torch.kernels.exchange.ref import exchange_ref, hash_keys
from repro_torch.kernels.flash_attention import kernel as fmod
from repro_torch.kernels.moe_dispatch import kernel as dmod
from repro_torch.kernels.moe_dispatch.ref import dispatch_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.rmsnorm import kernel as rmod
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.segment_reduce import kernel as kmod
from repro_torch.kernels.segment_reduce.ref import segment_sum_ref
from repro_torch.kernels.ssm_scan import kernel as smod
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.topk_reduce import kernel as tmod
from repro_torch.kernels.topk_reduce.ref import topk_ref

BF16, F32 = torch.bfloat16, torch.float32
CUDA = torch.device("cuda")   # a device name only: no card is touched


class Foreign(torch.Tensor):
    """A tensor's shape, strides and dtype on a device the wrappers do
    not take (``xpu``); any op on it raises."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(
            cls, t.shape, strides=t.stride(), dtype=t.dtype,
            device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a foreign device")

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
    with pytest.raises(ValueError):          # not cpu, cuda or meta
        fmod.flash_attention_kernel(Foreign(q), Foreign(k), Foreign(v),
                                    group=2)


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


SSM_ROUTES = [
    # steps, dtype, device, route
    (1, BF16, CUDA, "step"),            # a decode step
    (1, F32, CUDA, "step"),
    (2, BF16, CUDA, "chunked"),
    (127, F32, CUDA, "chunked"),
    (2048, BF16, CUDA, "chunked"),      # hymba's prefill
    (2065, F32, CUDA, "chunked"),
    (1, BF16, "cpu", "plain"),
    (2048, BF16, torch.device("cpu"), "plain"),
    (3, F32, "cpu", "plain"),
]


@pytest.mark.parametrize("t,dtype,device,want", SSM_ROUTES, ids=str)
def test_ssm_route_is_a_function_of_steps_dtype_device(t, dtype, device,
                                                       want):
    assert smod.route(t, dtype, device) == want


def _ssm_args(b=2, t=9, d=8, n=4, dtype=F32, seed=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, t, d), generator=g).to(dtype),
            (0.3 * torch.randn((d, 2 * n + 1), generator=g)).to(dtype),
            0.1 * torch.randn(d, generator=g),
            torch.log(1 + torch.rand((d, n), generator=g)),
            0.2 * torch.randn((b, d, n), generator=g))


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("t", [1, 9], ids=["step", "chunked"])
def test_ssm_cpu_tensor_takes_plain_version_and_moves_no_counter(t, dtype):
    args = _ssm_args(t=t, dtype=dtype)
    total, by_route = smod.LAUNCHES, dict(smod.LAUNCHES_BY_ROUTE)
    got = smod.ssm_scan_kernel(*args)
    assert smod.LAUNCHES == total and smod.LAUNCHES_BY_ROUTE == by_route
    want = ssm_scan_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ssm_reset_launches_zeroes_every_route():
    smod.LAUNCHES_BY_ROUTE["chunked"] += 2
    smod.LAUNCHES_BY_ROUTE["step"] += 5
    smod.LAUNCHES += 7
    smod.reset_launches()
    assert smod.LAUNCHES == 0
    assert smod.LAUNCHES_BY_ROUTE == {"chunked": 0, "step": 0}


@pytest.mark.parametrize("which", ["x_proj", "h0", "rank", "steps"])
def test_ssm_wrapper_checks_shapes_first(which):
    xc, x_proj, dt_bias, a_log, h0 = _ssm_args()
    bad = {"x_proj": (xc, x_proj[:, :-1], dt_bias, a_log, h0),
           "h0": (xc, x_proj, dt_bias, a_log, h0[:, :3]),
           "rank": (xc[0], x_proj, dt_bias, a_log, h0),
           "steps": (xc[:, :0], x_proj, dt_bias, a_log, h0)}[which]
    before = (smod.LAUNCHES, dict(smod.LAUNCHES_BY_ROUTE))
    with pytest.raises(ValueError):
        smod.ssm_scan_kernel(*(a.to("meta") for a in bad))
    with pytest.raises(ValueError):
        smod.ssm_scan_kernel(*bad)
    assert (smod.LAUNCHES, smod.LAUNCHES_BY_ROUTE) == before


def test_ssm_wrapper_rejects_foreign_devices():
    args = _ssm_args()
    with pytest.raises(ValueError, match="several devices"):
        smod.ssm_scan_kernel(args[0].to("meta"), *args[1:])
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        smod.ssm_scan_kernel(*(Foreign(a) for a in args))


SEGMENT_ROUTES = [
    # num_keys, d, n, device, route
    (4 ** 12, 1, 5_383_104, CUDA, "binned"),      # the k-mer combine
    (4 ** 12, 2, 16_784_112, CUDA, "binned"),     # the k-mer merge
    (4 ** 12, 3, 10, CUDA, "binned"),             # 8,192 tiles of 2,048
    (2 * 4 ** 12, 3, 10, CUDA, "atomic"),         # 16,384 tiles
    (2 ** 25, 1, 10, CUDA, "binned"),             # 8,192 tiles of 4,096
    (2 ** 25 + 1, 1, 10, CUDA, "atomic"),
    (1000003, 4, 10, CUDA, "atomic"),             # rows past 16 bytes
    (100, 128, 3000, CUDA, "atomic"),
    (100, 0, 3000, CUDA, "atomic"),               # counts only
    (1, 1, 1, CUDA, "binned"),
    (10, 1, 2 ** 31 - 1, CUDA, "binned"),
    (10, 1, 2 ** 31, CUDA, "atomic"),             # positions past int32
    (4 ** 12, 1, 5_383_104, "cpu", "plain"),
    (100, 128, 3000, torch.device("cpu"), "plain"),
]


@pytest.mark.parametrize("num_keys,d,n,device,want", SEGMENT_ROUTES,
                         ids=str)
def test_segment_route_is_a_function_of_keys_columns_records(num_keys, d,
                                                             n, device,
                                                             want):
    assert kmod.route(num_keys, d, n, device) == want


@pytest.mark.parametrize("d", [1, 2, 4])
def test_segment_cpu_tensor_takes_plain_version_and_moves_no_counter(d):
    g = torch.Generator().manual_seed(3)
    keys = torch.randint(-2, 40, (500,), dtype=torch.int32, generator=g)
    valid = torch.rand(500, generator=g) < 0.7
    vals = torch.randint(-9, 9, (500, d), dtype=torch.int32, generator=g)
    total, by_route = kmod.LAUNCHES, dict(kmod.LAUNCHES_BY_ROUTE)
    got = kmod.segment_sum(keys, vals, 37, valid)
    assert kmod.LAUNCHES == total and kmod.LAUNCHES_BY_ROUTE == by_route
    want = segment_sum_ref(keys, vals, 37, valid)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_segment_reset_launches_zeroes_every_route():
    kmod.LAUNCHES_BY_ROUTE["binned"] += 16
    kmod.LAUNCHES_BY_ROUTE["atomic"] += 1
    kmod.LAUNCHES += 17
    kmod.reset_launches()
    assert kmod.LAUNCHES == 0
    assert kmod.LAUNCHES_BY_ROUTE == {"binned": 0, "atomic": 0}


def test_segment_wrapper_rejects_foreign_devices_before_a_route():
    keys = Foreign(torch.zeros(4, dtype=torch.int32))
    vals = Foreign(torch.zeros((4, 1), dtype=torch.int32))
    valid = Foreign(torch.ones(4, dtype=torch.bool))
    before = (kmod.LAUNCHES, dict(kmod.LAUNCHES_BY_ROUTE))
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        kmod.segment_sum(keys, vals, 3, valid)
    with pytest.raises(ValueError, match="several devices"):
        kmod.segment_sum(torch.zeros(4, dtype=torch.int32), vals, 3, valid)
    assert (kmod.LAUNCHES, kmod.LAUNCHES_BY_ROUTE) == before


REACH = 8 * 1024 * 16
DISPATCH_ROUTES = [
    # n, groups, device, route
    (65536, 32, CUDA, "cluster"),             # granite's prefill
    (32, 32, CUDA, "cluster"),                # a decode step
    (1, 1, CUDA, "cluster"),
    (REACH, 32, CUDA, "cluster"),             # the cluster's reach
    (REACH + 1, 32, CUDA, "tiled"),
    (1000, 1024, CUDA, "cluster"),            # the most groups it holds
    (1000, 1025, CUDA, "tiled"),
    (100000, 5000, CUDA, "tiled"),
    (65536, 32, "cpu", "plain"),
    (REACH + 1, 5000, torch.device("cpu"), "plain"),
]


@pytest.mark.parametrize("n,groups,device,want", DISPATCH_ROUTES, ids=str)
def test_dispatch_route_is_a_function_of_ids_groups_device(n, groups,
                                                           device, want):
    assert dmod.route(n, groups, device) == want
    assert dmod.CLUSTER_REACH == REACH


@pytest.mark.parametrize("n,groups", [(300, 7), (REACH + 1, 32),
                                      (2000, 1025)])
def test_dispatch_cpu_tensor_takes_plain_version_and_moves_no_counter(
        n, groups):
    a = torch.randint(-1, groups + 1, (n,), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(4))
    before = (dmod.LAUNCHES, dict(dmod.LAUNCHES_BY_ROUTE))
    got = dmod.moe_dispatch_kernel(a, groups)
    assert (dmod.LAUNCHES, dmod.LAUNCHES_BY_ROUTE) == before
    assert all(torch.equal(x, y)
               for x, y in zip(got, dispatch_ref(a, groups)))


def test_dispatch_reset_launches_zeroes_every_route():
    dmod.LAUNCHES_BY_ROUTE["cluster"] += 768
    dmod.LAUNCHES_BY_ROUTE["tiled"] += 1
    dmod.LAUNCHES += 769
    dmod.reset_launches()
    assert dmod.LAUNCHES == 0
    assert dmod.LAUNCHES_BY_ROUTE == {"cluster": 0, "tiled": 0}


def test_dispatch_wrapper_rejects_foreign_devices_before_a_route():
    before = (dmod.LAUNCHES, dict(dmod.LAUNCHES_BY_ROUTE))
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        dmod.moe_dispatch_kernel(Foreign(torch.zeros(4, dtype=torch.int32)),
                                 3)
    assert (dmod.LAUNCHES, dmod.LAUNCHES_BY_ROUTE) == before


TOPK_ROUTES = [
    # k, n, device, route
    (30, 262144, CUDA, "select"),             # a VS shard combine
    (30, 60, CUDA, "select"),                 # the tree combines
    (30, 120, CUDA, "select"),
    (1, 1, CUDA, "select"),
    (32, 1 << 30, CUDA, "select"),
    (33, 262144, CUDA, "tree"),
    (64, 33, CUDA, "tree"),
    (1024, 1 << 23, CUDA, "tree"),
    (30, 262144, "cpu", "plain"),
    (1024, 5000, torch.device("cpu"), "plain"),
]


@pytest.mark.parametrize("k,n,device,want", TOPK_ROUTES, ids=str)
def test_topk_route_is_a_function_of_k_n_device(k, n, device, want):
    assert tmod.route(k, n, device) == want


@pytest.mark.parametrize("k", [1, 30, 32, 33, 100])
def test_topk_cpu_tensor_takes_plain_version_and_moves_no_counter(k):
    s = torch.randn(500, generator=torch.Generator().manual_seed(5))
    before = (tmod.LAUNCHES, dict(tmod.LAUNCHES_BY_ROUTE))
    got = tmod.topk_reduce_kernel(s, k, 470)
    assert (tmod.LAUNCHES, tmod.LAUNCHES_BY_ROUTE) == before
    assert all(torch.equal(x, y) for x, y in zip(got, topk_ref(s, k, 470)))


def test_topk_reset_launches_zeroes_every_route():
    tmod.LAUNCHES_BY_ROUTE["select"] += 13
    tmod.LAUNCHES_BY_ROUTE["tree"] += 1
    tmod.LAUNCHES += 14
    tmod.reset_launches()
    assert tmod.LAUNCHES == 0
    assert tmod.LAUNCHES_BY_ROUTE == {"select": 0, "tree": 0}


def test_topk_wrapper_rejects_foreign_devices_before_a_route():
    before = (tmod.LAUNCHES, dict(tmod.LAUNCHES_BY_ROUTE))
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        tmod.topk_reduce_kernel(Foreign(torch.zeros(40)), 3, 40)
    assert (tmod.LAUNCHES, tmod.LAUNCHES_BY_ROUTE) == before


EXCHANGE_ROUTES = [
    # device, keys hashed (else destinations given), route
    (CUDA, True, "hash"),
    (CUDA, False, "dests"),
    ("cpu", True, "plain"),
    (torch.device("cpu"), False, "plain"),
]


@pytest.mark.parametrize("device,hashed,want", EXCHANGE_ROUTES, ids=str)
def test_exchange_route_is_a_function_of_device_and_keys(device, hashed,
                                                         want):
    assert xmod.route(device, hashed) == want


@pytest.mark.parametrize("hashed", [True, False])
def test_exchange_cpu_tensor_takes_plain_version_and_moves_no_counter(
        hashed):
    g = torch.Generator().manual_seed(6)
    keys = [torch.randint(-50, 50, (300,), dtype=torch.int32, generator=g)
            for _ in range(3)]
    dests = [(k % 3).to(torch.int32) for k in keys]
    leaves = [[k, k.to(torch.float64)] for k in keys]
    counts = [torch.tensor(c, dtype=torch.int32) for c in (300, 120, 0)]
    before = (xmod.LAUNCHES, dict(xmod.LAUNCHES_BY_ROUTE))
    by = dict(keys=keys) if hashed else dict(dests=dests)
    got = xmod.exchange(leaves, counts, 90, **by)
    assert (xmod.LAUNCHES, xmod.LAUNCHES_BY_ROUTE) == before
    want = exchange_ref(leaves, counts, 90, [hash_keys(k) % 3 for k in keys]
                        if hashed else dests)
    assert all(torch.equal(x, y) for x, y in zip(
        (*got.leaves, got.counts, got.send_counts, got.dropped),
        (*want.leaves, want.counts, want.send_counts, want.dropped)))


def test_exchange_reset_launches_zeroes_every_route():
    xmod.LAUNCHES_BY_ROUTE["hash"] += 2
    xmod.LAUNCHES_BY_ROUTE["dests"] += 1
    xmod.LAUNCHES += 3
    xmod.reset_launches()
    assert xmod.LAUNCHES == 0
    assert xmod.LAUNCHES_BY_ROUTE == {"hash": 0, "dests": 0}


def test_exchange_wrapper_rejects_foreign_devices_before_a_route():
    before = (xmod.LAUNCHES, dict(xmod.LAUNCHES_BY_ROUTE))
    k = Foreign(torch.zeros(4, dtype=torch.int32))
    c = Foreign(torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        xmod.exchange([[k]], [c], 4, keys=[k])
    assert (xmod.LAUNCHES, xmod.LAUNCHES_BY_ROUTE) == before
