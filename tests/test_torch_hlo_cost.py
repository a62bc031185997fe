"""The port's work counter (``repro_torch/launch/hlo_cost.py``).

First the reference's own cases (``tests/test_hlo_cost.py``) on the
port's counter, with the reference's bounds: a matmul's FLOPs (also
against the reference's HLO walk of the same product), a loop of 13
bodies counted once each against 13 unrolled, nested loops, and the
bytes of a stacked weight's slices.  The port's loops are Python loops,
so the reference's trip-count rule becomes ``like_bodies`` under a
counter that counts loops once: the first, second and last body run,
the second counted for those between.  Then the kernels' work formulas
against ``PERF.md`` §6's bound column, each wrapper's meta route against
its plain version's outputs (shapes and dtypes) with its report to the
counter, and the collectives' reports with the reference's ring
factors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_cost import analyze as ref_analyze
from repro_torch.core import collectives as coll
from repro_torch.kernels import work
from repro_torch.kernels.flash_attention import backward as fbmod
from repro_torch.kernels.flash_attention import kernel as fmod
from repro_torch.kernels.moe_dispatch import kernel as dmod
from repro_torch.kernels.rmsnorm import kernel as rmod
from repro_torch.kernels.segment_reduce import kernel as kmod
from repro_torch.kernels.ssm_scan import backward as sbmod
from repro_torch.kernels.ssm_scan import kernel as smod
from repro_torch.kernels.topk_reduce import kernel as tmod
from repro_torch.launch import hlo_cost

META = torch.device("meta")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_matmul_flops_exact(device):
    a = torch.zeros((256, 256), device=device)
    r = hlo_cost.analyze(lambda a, b: a @ b, a, a)
    assert abs(r["flops"] - 2 * 256 ** 3) / (2 * 256 ** 3) < 0.01
    ja = jnp.zeros((256, 256), jnp.float32)
    ref = ref_analyze(jax.jit(lambda a, b: a @ b).lower(ja, ja).compile()
                      .as_text())
    assert abs(r["flops"] - ref["flops"]) / ref["flops"] < 0.01
    assert r["bytes"] == 3 * 256 * 256 * 4      # a, b read, out written


def test_scan_trip_count_multiplies():
    """A loop whose 13 bodies run one by one, and the same loop with its
    second body counted for the eleven between the first and the last
    (the reference's scan-of-13 == unrolled-13)."""
    a = torch.zeros((128, 128), device=META)

    def scanned(a):
        x = a
        for _ in hlo_cost.like_bodies(13):
            x = torch.tanh(x @ a)
        return x

    fs = hlo_cost.analyze(scanned, a, count_loops_once=True)["flops"]
    fu = hlo_cost.analyze(scanned, a)["flops"]
    one = hlo_cost.analyze(lambda a: torch.tanh(a @ a), a)["flops"]
    assert abs(fs - fu) / fu < 0.02
    assert fs == fu == 13 * one
    assert one < fs / 5          # a body counted once is the undercount


def test_nested_scan():
    a = torch.zeros((64, 64), device=META)

    def nested(a):
        x = a
        for _ in hlo_cost.like_bodies(3):
            y = x
            for _ in hlo_cost.like_bodies(4):
                y = y @ a
            x = y
        return x

    expect = 12 * 2 * 64 ** 3
    for once in (False, True):
        r = hlo_cost.analyze(nested, a, count_loops_once=once)
        assert abs(r["flops"] - expect) / expect < 0.05


@pytest.mark.parametrize("once", [False, True])
def test_slice_bytes_not_full_buffer(once):
    """A slice of a big stacked buffer is a view: its consumer reads the
    slice, not the stack (the per-layer weight slicing pattern)."""
    w = torch.zeros((30, 256, 256), device=META)
    x = torch.zeros((4, 256), device=META)

    def f(w, x):
        for i in hlo_cost.like_bodies(30):
            x = x @ w[i]
        return x

    r = hlo_cost.analyze(f, w, x, count_loops_once=once)
    # the whole stack each iteration would be 30 * 7.8 MB = 236 MB;
    # the traffic is 30 * (slice 256 KB + x 4 KB + out 4 KB)
    assert r["bytes"] < 60e6, r["bytes"]
    assert r["bytes"] == 30 * 4 * (256 * 256 + 2 * 4 * 256)


def test_like_bodies_gradient_counts_every_body():
    """Under a counter that counts loops once, a gradient's matmuls count
    for every body, as when each body runs."""
    w = torch.zeros((32, 32), device=META, requires_grad=True)

    def step(w):
        x = torch.zeros((8, 32), device=META)
        for _ in hlo_cost.like_bodies(9):
            x = torch.tanh(x @ w)
        x.sum().backward()

    r1 = hlo_cost.analyze(step, w)
    r2 = hlo_cost.analyze(step, w, count_loops_once=True)
    assert r1["matmul_flops"] == r2["matmul_flops"] > 9 * 2 * 8 * 32 * 32


def test_views_and_transfers_count_no_bytes():
    x = torch.zeros((64, 64), device=META)
    r = hlo_cost.analyze(lambda x: (x.t(), x.reshape(-1), x[3],
                                    x.view(8, 512), torch.empty_like(x)), x)
    assert r["bytes"] == 0 and r["flops"] == 0
    y = torch.zeros((64, 64))
    assert hlo_cost.analyze(lambda y: y.to(META), y)["bytes"] == 0


def test_counter_is_off_unless_entered():
    assert hlo_cost.active() is None
    with hlo_cost.Counter() as c:
        assert hlo_cost.active() is c
    assert hlo_cost.active() is None
    hlo_cost.report_kernel("flash_attention", None)   # not evaluated


# -- the kernels' work formulas ---------------------------------------------

def test_work_formulas_pin_the_kernel_table_bounds():
    """``PERF.md`` §6's bound column, from the formulas at its shapes."""
    def ms(w):
        return w.bound()[0]
    # flash, Llama's prefill: q [4, 32, 2048, 64], k/v [4, 8, ...] causal
    assert round(ms(work.flash(128, 4, 2048, 2048, 64, True, None, 2)),
                 4) == 0.0695
    assert round(ms(work.flash_bwd(128, 4, 2048, 2048, 64, True, None, 2)),
                 5) == 0.17379
    assert round(ms(work.ssm(4, 2048, 1600, 16, 2)), 4) == 0.0358
    assert round(ms(work.ssm_bwd(4, 2048, 1600, 16, 2)), 5) == 0.09762
    assert round(ms(work.rmsnorm(8192, 2048, 2)), 4) == 0.0200
    assert round(ms(work.dispatch(65536, 32)), 6) == 0.000157
    assert round(ms(work.topk(262144, 30)), 6) == 0.000313
    combine, merge = 5_383_104, 16_784_112
    assert round(ms(work.segment_sum(combine, round(0.9188 * combine), 1,
                                     4 ** 12)), 4) == 0.0535
    assert round(ms(work.segment_sum(merge, round(0.2450 * merge), 2,
                                     4 ** 12)), 4) == 0.0798
    # the Mamba mixer's rows at Jamba's prefill [1, 65536, 8192] bf16:
    # the gated dt route (6b) and the conv (6c)
    assert round(ms(work.ssm_dt(1, 65536, 8192, 16, 2)), 4) == 1.2838
    assert round(ms(work.mamba_conv(1, 65536, 8192, 4, 2)), 4) == 0.6411
    assert work.flash(128, 4, 2048, 2048, 64, True, None, 2).bound()[1] \
        == "operations"
    assert work.rmsnorm(8192, 2048, 2).bound()[1] == "bytes"


def test_ssm_chunk_is_the_kernel_chunk():
    assert work.SSM_CHUNK == smod.CHUNK
    assert work.ssm_row_floats(16) == smod._proj_row_floats(16)


def test_flash_pairs_count_masks():
    assert work.flash_pairs(4, 4, True, None) == 10
    assert work.flash_pairs(4, 4, False, None) == 16
    assert work.flash_pairs(4, 4, True, 2) == 7
    assert work.flash_pairs(2, 4, True, None) == 7   # right-aligned rows


# -- meta routes --------------------------------------------------------------

def _meta(*ts):
    return tuple(t.to(META) for t in ts)


def _same_layout(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device == META
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


def _routed(name, mod, call, cpu_args, meta_args, formula):
    """The meta call's outputs have the plain call's shapes and dtypes,
    it launches nothing, and it reports ``formula`` once."""
    want = call(*cpu_args)
    before = mod.LAUNCHES
    with hlo_cost.Counter() as c:
        got = call(*meta_args)
    assert mod.LAUNCHES == before
    _same_layout(got, want)
    assert c.kernels == {name: {"calls": 1, "ops": formula.ops,
                                "bytes": formula.nbytes}}
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lse", [False, True])
def test_flash_meta_route(dtype, lse):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((6, 5, 16), generator=g).to(dtype)
    k = torch.randn((3, 7, 16), generator=g).to(dtype)
    v = torch.randn((3, 7, 16), generator=g).to(dtype)

    def call(q, k, v):
        return fmod.flash_attention_kernel(q, k, v, group=2, causal=True,
                                           window=4, return_lse=lse)
    assert fmod.route(dtype, 16, META) == "meta"
    _routed("flash_attention", fmod, call, (q, k, v), _meta(q, k, v),
            work.flash(6, 2, 5, 7, 16, True, 4, q.element_size(), lse=lse))


def test_flash_backward_meta_route():
    g = torch.Generator().manual_seed(1)
    q, o, do = (torch.randn((4, 6, 32), generator=g) for _ in range(3))
    k, v = (torch.randn((2, 6, 32), generator=g) for _ in range(2))
    lse = torch.randn((4, 6), generator=g)

    def call(*a):
        return fbmod.flash_attention_bwd_kernel(*a, group=2, causal=True)
    _routed("flash_attention_bwd", fbmod, call, (q, k, v, o, do, lse),
            _meta(q, k, v, o, do, lse),
            work.flash_bwd(4, 2, 6, 6, 32, True, None, 4))


def _ssm_args(b=2, t=5, d=6, n=3):
    g = torch.Generator().manual_seed(2)
    return (torch.randn((b, t, d), generator=g),
            torch.randn((d, 2 * n + 1), generator=g),
            torch.randn((d,), generator=g), torch.randn((d, n), generator=g),
            torch.randn((b, d, n), generator=g))


@pytest.mark.parametrize("t", [1, 5, 300])
def test_ssm_meta_route(t):
    args = _ssm_args(t=t)
    assert smod.route(t, torch.float32, META) == "meta"
    _routed("ssm_scan", smod, smod.ssm_scan_kernel, args, _meta(*args),
            work.ssm(2, t, 6, 3, 4))


def test_ssm_meta_route_saves_the_chunk_states():
    b, t, d, n = 2, 300, 6, 3
    args = _meta(*_ssm_args(b, t, d, n))
    with hlo_cost.Counter() as c:
        y, h, (proj, h_end) = smod.ssm_scan_kernel(*args, save=True)
    assert tuple(proj.shape) == (b * t, work.ssm_row_floats(n))
    assert tuple(h_end.shape) == (b, -(-t // smod.CHUNK) - 1, n, d)
    assert proj.dtype == h_end.dtype == torch.float32
    w = work.ssm(b, t, d, n, 4, save=True)
    assert c.kernels["ssm_scan"] == {"calls": 1, "ops": w.ops,
                                     "bytes": w.nbytes}
    dy = torch.empty((b, t, d), device=META)
    dh = torch.empty((b, d, n), device=META)
    before = sbmod.LAUNCHES
    with hlo_cost.Counter() as c:
        grads = sbmod.ssm_scan_bwd_kernel(*args, dy, dh, proj, h_end)
    assert sbmod.LAUNCHES == before
    cpu = _ssm_args(b, t, d, n)
    _same_layout(tuple(grads), tuple(sbmod.ssm_scan_bwd_kernel(
        *cpu, torch.zeros((b, t, d)), torch.zeros((b, d, n)))))
    w = work.ssm_bwd(b, t, d, n, 4)
    assert c.kernels == {"ssm_scan_bwd": {"calls": 1, "ops": w.ops,
                                          "bytes": w.nbytes}}


def test_rmsnorm_meta_route():
    x, w = torch.randn((5, 32)), torch.randn((32,))
    _routed("rmsnorm", rmod, rmod.rmsnorm_kernel, (x, w), _meta(x, w),
            work.rmsnorm(5, 32, 4))


def test_dispatch_meta_route():
    a = torch.tensor([3, 1, 3, 0, 2, 3], dtype=torch.int32)
    _routed("moe_dispatch", dmod, dmod.moe_dispatch_kernel, (a, 4),
            (a.to(META), 4), work.dispatch(6, 4))


def test_topk_meta_route():
    s = torch.randn((40,))
    _routed("topk_reduce", tmod, tmod.topk_reduce_kernel, (s, 5, 30),
            (s.to(META), 5, 30), work.topk(40, 5))


def test_segment_sum_meta_route():
    keys = torch.tensor([0, 2, 2, 5, 1], dtype=torch.int32)
    vals = torch.ones((5, 2), dtype=torch.float32)
    valid = torch.tensor([True, True, False, True, True])
    assert kmod.route(8, 2, 5, META) == "meta"
    _routed("segment_sum", kmod, kmod.segment_sum, (keys, vals, 8, valid),
            (keys.to(META), vals.to(META), 8, valid.to(META)),
            work.segment_sum(5, 5, 2, 8))


def test_plain_routes_are_counted_op_by_op():
    """A CPU call takes the plain version: no kernel report, its ops
    counted."""
    s = torch.randn((40,))
    with hlo_cost.Counter() as c:
        tmod.topk_reduce_kernel(s, 5, 30)
    assert c.kernels == {} and c.ops > 0


# -- collectives -------------------------------------------------------------

def test_collectives_report_with_ring_factors():
    mesh = coll.Mesh((2, 4), ("data", "model"))
    xs = [torch.zeros((4, 3), device=META) for _ in range(mesh.size)]
    with hlo_cost.Counter() as c:
        coll.psum(xs, mesh, "model")
        coll.all_gather(xs, mesh, "model", tiled=True)
        coll.psum_scatter(xs, mesh, "model", tiled=True)
        coll.all_to_all(xs, mesh, "model")
        coll.ppermute(xs, mesh, "model", [(0, 1)])
    r = c.result()
    one = 4 * 3 * 4
    assert r["coll_bytes_by_op"] == {
        "all-reduce": one, "all-gather": 4 * one, "reduce-scatter": one // 4,
        "all-to-all": one, "collective-permute": one}
    assert r["coll_counts"] == {k: 1 for k in hlo_cost.COLLECTIVES}
    n = 4                                   # the mesh's largest axis
    assert r["wire_bytes"] == pytest.approx(
        one * 2 * (n - 1) / n + (4 * one + one // 4 + one) * (n - 1) / n
        + one)
    assert r["flops"] == 0                 # the stand-in adds are not work


def test_collective_gradient_reports_its_transpose():
    mesh = coll.Mesh((4,), ("data",))
    w = torch.zeros((4, 3), device=META, requires_grad=True)

    def step(w):
        xs = coll.shard(w, mesh, ("data",))
        out = coll.all_gather(xs, mesh, "data", tiled=True)
        sum(o.sum() for o in out).backward()

    with hlo_cost.Counter() as c:
        step(w)
    assert c.coll_counts["all-gather"] == 1
    assert c.coll_counts["reduce-scatter"] == 1
    assert c.coll_bytes["reduce-scatter"] == 3 * 4     # one shard's block


def test_scaled_counts_keep_integers():
    r = hlo_cost.analyze(lambda: np.int64(0))
    assert isinstance(r["flops"], int) and isinstance(r["bytes"], int)


def test_exchange_meta_route():
    """The meta call's outputs have the plain call's shapes and dtypes,
    it launches nothing, and it reports the exchange's formula once (every
    row taken as valid)."""
    from repro_torch.kernels.exchange import kernel as xmod
    keys = [torch.tensor([3, -1, 7, 7, 2], dtype=torch.int32),
            torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32)]
    leaves = [[k, k.float()[:, None].repeat(1, 3)] for k in keys]
    counts = [torch.tensor(5, dtype=torch.int32),
              torch.tensor(2, dtype=torch.int32)]

    def flat(e):
        return (*e.leaves, e.counts, e.send_counts, e.dropped)

    want = xmod.exchange(leaves, counts, 4, keys=keys)
    before = xmod.LAUNCHES
    assert xmod.route(META, True) == "meta"
    with hlo_cost.Counter() as c:
        got = xmod.exchange([[x.to(META) for x in s] for s in leaves],
                            [n.to(META) for n in counts], 4,
                            keys=[k.to(META) for k in keys])
    assert xmod.LAUNCHES == before
    _same_layout(flat(got), flat(want))
    w = work.exchange(2, 10, 4, 16, 4)
    assert c.kernels == {"exchange": {"calls": 1, "ops": w.ops,
                                      "bytes": w.nbytes}}
