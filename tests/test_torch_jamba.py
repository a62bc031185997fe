"""AI21-Jamba2-Mini on the port against its plain float32 reference.

The JAX package has no Jamba, so the port is held to
``repro_torch.models.jamba_ref`` (plain ``torch``, written from the
published ``modeling_jamba.py``; it imports nothing of the port) on
seeded random weights at small widths, on the CPU:

* the published Mamba-1 mixer (``ssm.mamba_mixer``) against the
  reference's, whole-sequence and stepped through its state;
* the scan's dt route through its plain version, and the CUDA route's
  chunked passes in tensor code (``ssm_scan_dt_chunked_ref``), against
  the sequential scan; its meta route and its checks;
* prefill, then decode through the cache, against the reference's full
  forward, in logits; ``logits_to_keep``; the layer pattern from the
  period and offset keys; the MoE without drops and with expert buffers
  whose size does not depend on the routing;
* planted faults (dt/B/C norms left out, the scan state in bfloat16,
  the gates renormalised, RoPE put back) that the same tolerance must
  catch.

Tolerances: 2e-5 of the largest |logit| (or |y|) where both sides run in
float32: the two differ only in the order of sums (the port's conv and
scan accumulate in another order, its attention splits its softmax
differently), ~1e-6 measured; each planted fault moves the logits by
1e-3 or more of that largest value at these widths.
"""
import dataclasses
import functools

import pytest
import torch

from repro_torch.configs import (ARCH_IDS, EXTRA_ARCH_IDS, get_config,
                                 get_smoke_config)
from repro_torch.kernels import work
from repro_torch.kernels.ssm_scan import kernel as smod
from repro_torch.kernels.ssm_scan import ssm_scan_dt, ssm_scan_dt_ref
from repro_torch.kernels.ssm_scan.ref import ssm_scan_dt_chunked_ref
from repro_torch.launch import hlo_cost
from repro_torch.models import build_model, jamba_ref
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer
from repro_torch.models.common import (param_count, param_count_analytic)
from repro_torch.obs import METRICS

TOL = 2e-5


def published(cfg):
    """The reference's keys for a port config."""
    return dict(hidden_size=cfg.d_model, num_attention_heads=cfg.num_heads,
                num_key_value_heads=cfg.num_kv_heads,
                num_experts=cfg.num_experts,
                num_experts_per_tok=cfg.experts_per_token,
                mamba_d_state=cfg.ssm_state, mamba_dt_rank=cfg.ssm_dt_rank,
                mamba_d_conv=cfg.ssm_conv,
                mamba_conv_bias=cfg.ssm_conv_bias,
                rms_norm_eps=cfg.norm_eps,
                attn_layer_period=cfg.attn_layer_period,
                attn_layer_offset=cfg.attn_layer_offset,
                expert_layer_period=cfg.expert_layer_period,
                expert_layer_offset=cfg.expert_layer_offset,
                num_hidden_layers=cfg.num_layers)


def perturb(params, seed):
    """Every norm weight in [0.9, 1.1] and the conv bias in +-0.5, so that
    a norm's weight or the bias left out shows (their initial values are
    ones and zeros)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in params.named_parameters():
            if name.endswith(".scale"):
                t.copy_(0.9 + 0.2 * torch.rand(t.shape, generator=g))
            elif name.endswith("conv_b"):
                t.copy_(torch.rand(t.shape, generator=g) - 0.5)
    return params


@functools.lru_cache(maxsize=None)
def smoke(seed=0):
    cfg = get_smoke_config("jamba2-mini")
    model = build_model(cfg, device="cpu")
    return cfg, model, perturb(model.init(seed), seed)


def reference_logits(cfg, params, seqs, positions, **kw):
    outer = {k: v for k, v in params.named_parameters()
             if not k.startswith("blocks.")}
    return jamba_ref.forward(
        published(cfg), outer,
        lambda i: dict(params.blocks[i].named_parameters()), seqs,
        positions, **kw)


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_not_an_assigned_arch():
    assert "jamba2-mini" in EXTRA_ARCH_IDS and "jamba2-mini" not in ARCH_IDS
    assert get_config("jamba2-mini").family == "jamba"


def test_layer_pattern_from_period_and_offset():
    cfg = get_config("jamba2-mini")
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    assert [i for i, k in enumerate(kinds) if k[0] == "attention"] == \
        [4, 12, 20, 28]
    assert [i for i, k in enumerate(kinds) if k[1] == "moe"] == \
        list(range(1, 32, 2))
    assert kinds == [tuple(k) for k in
                     jamba_ref.layer_kinds(published(cfg))]
    _, _, params = smoke()
    for i, bp in enumerate(params.blocks):
        mixer, ffn = get_smoke_config("jamba2-mini").layer_kind(i)
        names = {n.split(".")[0] for n, _ in bp.named_parameters()}
        assert names == {"norm1", "norm2", ffn,
                         "attn" if mixer == "attention" else "mamba"}


def test_published_sizes_and_count():
    cfg = get_config("jamba2-mini").scaled(num_layers=8)
    assert (cfg.d_model, cfg.hd, cfg.ssm_dt_rank, cfg.ssm_expand,
            cfg.moe_d_ff, cfg.num_experts, cfg.experts_per_token) == \
        (4096, 128, 256, 2, 14336, 16, 2)
    params = build_model(cfg, device="meta").init(0)
    assert param_count(params) == param_count_analytic(cfg) == 13295237088
    cfg_s, _, small = smoke()
    assert param_count(small) == param_count_analytic(cfg_s)


@pytest.mark.parametrize("seed", [0, 1])
def test_mamba_mixer_against_reference(seed):
    cfg, _, params = smoke()
    p = params.blocks[0].mamba
    x = torch.randn((1, 37, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        got, _ = ssm_lib.mamba_mixer(p, x, cfg)
        w = {f"mamba.{k}": v for k, v in p.named_parameters()}
        want = jamba_ref.mamba(w, x[0], published(cfg))
        assert rel_err(got[0], want) < TOL
        # stepped through the state, one token at a time from zero
        st = ssm_lib.init_ssm_state(cfg, 1)
        rows = []
        for t in range(x.shape[1]):
            y, st = ssm_lib.mamba_mixer(p, x[:, t:t + 1], cfg, state=st)
            rows.append(y[0, 0])
        assert rel_err(torch.stack(rows), want) < TOL


def _dt_inputs(seed, b, t, d, n):
    g = torch.Generator().manual_seed(seed)
    step = torch.exp(torch.rand((d,), generator=g) * 4.6 - 6.9)
    return (torch.randn((b, t, d), generator=g),
            torch.randn((b, t, d), generator=g),
            step + torch.log(-torch.expm1(-step)),
            torch.randn((b, t, n), generator=g),
            torch.randn((b, t, n), generator=g),
            torch.log(torch.arange(1, n + 1.0)).repeat(d, 1),
            torch.randn((b, d, n), generator=g) * 0.5)


@pytest.mark.parametrize("t,chunk", [(1, 4), (3, 4), (4, 4), (5, 4),
                                     (17, 4), (40, 16)])
def test_dt_route_chunked_passes(t, chunk):
    args = _dt_inputs(t, 2, t, 12, 5)
    y, h = ssm_scan_dt_ref(*args)
    yc, hc = ssm_scan_dt_chunked_ref(*args, chunk=chunk)
    assert rel_err(yc, y) < 1e-5 and rel_err(hc, h) < 1e-5


def test_dt_route_plain_against_definition():
    u, dt, bias, bm, cm, a_log, h0 = _dt_inputs(7, 2, 9, 6, 3)
    y, h = ssm_scan_dt(u, dt, bias, bm, cm, a_log, h0)
    hh = h0.clone()
    for t in range(9):
        d_t = torch.nn.functional.softplus(dt[:, t] + bias)       # [b, d]
        hh = torch.exp(-torch.exp(a_log) * d_t[..., None]) * hh \
            + (d_t * u[:, t])[..., None] * bm[:, t, None, :]
        assert rel_err(y[:, t], (hh * cm[:, t, None, :]).sum(-1)) < 1e-6
    assert rel_err(h, hh) < 1e-6


def test_dt_route_counts_and_checks():
    args = _dt_inputs(3, 1, 5, 8, 4)
    before = (smod.LAUNCHES, smod.DT_LAUNCHES, dict(smod.LAUNCHES_BY_ROUTE))
    ssm_scan_dt(*args)
    assert (smod.LAUNCHES, smod.DT_LAUNCHES,
            dict(smod.LAUNCHES_BY_ROUTE)) == before   # the CPU: no launch
    bad = list(args)
    bad[3] = bad[3][:, :, :3]
    with pytest.raises(ValueError, match="B is"):
        smod.ssm_scan_dt_kernel(*bad)


def test_dt_route_meta_reports_its_work():
    meta = [a.to("meta") for a in _dt_inputs(0, 1, 300, 64, 16)]
    with hlo_cost.Counter() as c:
        y, h = smod.ssm_scan_dt_kernel(*meta)
    assert y.shape == (1, 300, 64) and h.shape == (1, 64, 16)
    want = work.ssm_dt(1, 300, 64, 16, 4)
    assert c.kernels["ssm_scan"]["calls"] == 1
    assert c.kernels["ssm_scan"]["ops"] == want.ops
    assert c.kernels["ssm_scan"]["bytes"] == want.nbytes


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_then_decode_against_reference(seed):
    cfg, model, params = smoke()
    g = torch.Generator().manual_seed(100 + seed)
    prompt = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    follow = torch.randint(0, cfg.vocab_size, (2, 6), generator=g)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompt}, 30)
        assert logits.shape == (2, 1, cfg.vocab_size)
        rows = [logits[:, -1]]
        for t in range(6):
            lg, cache = model.decode_step(params, cache, follow[:, t])
            rows.append(lg)
    got = torch.stack(rows, dim=1)                       # [2, 7, V]
    seqs = torch.cat([prompt, follow], dim=1)
    want = reference_logits(cfg, params, list(seqs), range(23, 30))
    for b in range(2):
        assert rel_err(got[b], want[b]) < TOL
    kinds = [c.kind for c in cache]
    assert kinds == ["mamba"] * 4 + ["attention"] + ["mamba"] * 3
    assert cache[4].kv.pos == 30


def test_logits_to_keep():
    cfg, _, params = smoke()
    tokens = torch.randint(0, cfg.vocab_size, (1, 16),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        last, _ = transformer.prefill(params, tokens, cfg)
        every, _ = transformer.prefill(
            params, tokens, dataclasses.replace(cfg, logits_to_keep=0))
        three, _ = transformer.prefill(
            params, tokens, dataclasses.replace(cfg, logits_to_keep=3))
        full, _ = transformer.forward(params, tokens, cfg)
    assert last.shape == (1, 1, cfg.vocab_size)
    assert every.shape == (1, 16, cfg.vocab_size)
    # the head's product over 1 or 3 rows sums in another order
    assert rel_err(last[:, 0], every[:, -1]) < 1e-6
    assert rel_err(three, every[:, -3:]) < 1e-6
    assert rel_err(every, full) < TOL


def test_moe_no_drops_and_routing_free_buffers(monkeypatch):
    cfg, _, params = smoke()
    p = params.blocks[1].moe
    x = torch.randn((2, 20, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    shapes = []
    real_empty = torch.empty

    def empty(*size, **kw):
        shapes.append(tuple(size[0]) if len(size) == 1 and isinstance(
            size[0], (tuple, list)) else tuple(size))
        return real_empty(*size, **kw)

    dropped = METRICS.counter("moe.dropped").value
    tokens = sum(METRICS.counter(f"moe.expert_tokens.{e}").value
                 for e in range(cfg.num_experts))
    seen = []
    for router in (p.router, torch.zeros_like(p.router)):   # two routings
        q = {"router": router, "w1": p.w1, "w3": p.w3, "w2": p.w2}
        shapes.clear()
        monkeypatch.setattr(torch, "empty", empty)
        with torch.no_grad():
            y, stats = moe_lib.moe_ffn(q, x, cfg)
        monkeypatch.setattr(torch, "empty", real_empty)
        seen.append(list(shapes))
        assert float(stats.dropped) == 0
        # the loop under autograd computes the same values
        qg = {k: v.detach().clone().requires_grad_() for k, v in q.items()}
        yg, _ = moe_lib.moe_ffn(qg, x, cfg)
        assert torch.equal(y, yg.detach())
    assert seen[0] == seen[1]
    assert (80, cfg.moe_d_ff) in seen[0]           # n*k rows: 40 x 2
    assert METRICS.counter("moe.dropped").value == dropped
    now = sum(METRICS.counter(f"moe.expert_tokens.{e}").value
              for e in range(cfg.num_experts))
    assert now - tokens == 4 * 80              # 2 routings x 2 calls


def test_gates_kept_as_they_are():
    cfg, _, params = smoke()
    x = torch.randn((7, cfg.d_model), generator=torch.Generator()
                    .manual_seed(9))
    idx, gates, _ = moe_lib._route(params.blocks[1].moe, x, cfg)
    probs = torch.softmax(x @ params.blocks[1].moe.router, dim=-1)
    assert torch.allclose(gates, torch.gather(probs, 1, idx))
    assert float(gates.sum(-1).max()) < 1.0


def _bf16_state_scan(u, dt, dt_bias, bm, cm, a_log, h0=None):
    """The scan with its state rounded to bfloat16 every step."""
    b, t, d = u.shape
    n = a_log.shape[1]
    h = torch.zeros((b, d, n)) if h0 is None else h0.float()
    dtp = torch.nn.functional.softplus(dt.float() + dt_bias)
    ys = []
    for i in range(t):
        h = (torch.exp(-torch.exp(a_log) * dtp[:, i, :, None]) * h
             + (dtp[:, i] * u[:, i])[..., None] * bm[:, i, None, :]
             ).bfloat16().float()
        ys.append((h * cm[:, i, None, :]).sum(-1))
    return torch.stack(ys, 1), h


FAULTS = {
    "dt, B and C norms left out":
        lambda mp: mp.setattr(ssm_lib, "apply_rmsnorm",
                              lambda p, x, eps=1e-6: x),
    "scan state in bfloat16":
        lambda mp: mp.setattr(ssm_lib, "ssm_scan_dt", _bf16_state_scan),
    "gates renormalised":
        lambda mp: mp.setattr(moe_lib, "_route", functools.partial(
            _renormalised_route, moe_lib._route)),
    "RoPE in the attention layer":
        lambda mp: mp.setattr(transformer.attn_lib, "_project_qkv",
                              functools.partial(
                                  _with_rope,
                                  transformer.attn_lib._project_qkv)),
}


def _renormalised_route(route, p, x2d, cfg):
    return route(p, x2d, dataclasses.replace(cfg, moe_renormalize=True))


def _with_rope(project, p, x, positions, cfg, rope=True):
    return project(p, x, positions, cfg, rope=True)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails(monkeypatch, fault):
    cfg, model, params = smoke()
    tokens = torch.randint(0, cfg.vocab_size, (1, 48),
                           generator=torch.Generator().manual_seed(11))
    want = reference_logits(cfg, params, [tokens[0]], range(48))[0]
    with torch.no_grad():
        good, _ = model.forward(params, {"tokens": tokens}), None
    assert rel_err(good[0], want) < TOL
    FAULTS[fault](monkeypatch)
    with torch.no_grad():
        bad = model.forward(params, {"tokens": tokens})
    assert rel_err(bad[0], want) > 50 * TOL


def test_serve_model_smoke_runs_jamba():
    import argparse
    from repro_torch.launch.serve import greedy_request, model_smoke
    args = argparse.Namespace(arch="jamba2-mini", smoke=True, device="cpu",
                              seed=0, batch=2, prompt_len=12, gen=4)
    run = model_smoke(args)
    assert run.generated.shape == (2, 4)
    before = METRICS.counter("lm.tokens_decoded").value
    req = greedy_request(run.model, run.params, torch.zeros(
        (1, 12), dtype=torch.long), 3)
    assert req.ids.shape == (1, 4) and req.logits.shape == (1, 4, 256)
    assert set(req.report.phases) >= {"dispatch", "device_wait", "prefill",
                                      "decode"}
    assert METRICS.counter("lm.tokens_decoded").value - before == 3


def test_spans_of_a_request():
    from repro_torch import obs
    cfg, model, params = smoke()
    with obs.tracing() as t, torch.no_grad():
        _, cache = model.prefill(params, {"tokens": torch.zeros(
            (1, 8), dtype=torch.long)}, 10)
        model.decode_step(params, cache, torch.zeros((1,), dtype=torch.long))
    names = [e["name"] for e in t.events()]
    for name in ("lm.prefill", "lm.decode_step", "lm.mamba", "lm.moe",
                 "lm.attention"):
        assert name in names, name
    assert names.count("lm.mamba") == 14 and names.count("lm.moe") == 8


def test_reference_imports_nothing_of_the_port():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(jamba_ref))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    assert found <= {"__future__", "contextlib", "contextvars", "math",
                     "typing", "torch"}


def test_reference_follows_routing_only_within_the_margin():
    cfg, model, params = smoke()
    tokens = torch.randint(0, cfg.vocab_size, (1, 30),
                           generator=torch.Generator().manual_seed(21))
    with moe_lib.record_routing() as routes, torch.no_grad():
        model.forward(params, {"tokens": tokens})
    assert [tuple(r.shape) for r in routes] == [(30, 2)] * 4
    want = reference_logits(cfg, params, [tokens[0]], range(30))[0]
    stats = {}
    same = reference_logits(cfg, params, [tokens[0]], range(30),
                            routing=[routes], stats=stats)[0]
    assert stats == {"routing_rows": 4 * 30, "routing_flips": 0,
                     "routing_wrong": 0, "routing_deficit": 0.0}
    assert rel_err(same, want) < 1e-6
    # every row's experts moved by one: none within a zero margin, so
    # each is counted and the reference keeps its own choice
    moved = [(r + 1) % cfg.num_experts for r in routes]
    stats = {}
    kept = reference_logits(cfg, params, [tokens[0]], range(30),
                            routing=[moved], stats=stats)[0]
    assert stats["routing_wrong"] == stats["routing_flips"] == 4 * 30
    assert stats["routing_deficit"] > 0
    assert rel_err(kept, want) < 1e-6
    # within a margin that takes any choice, the moved experts are used
    taken = reference_logits(cfg, params, [tokens[0]], range(30),
                             routing=[moved], route_margin=1e9)[0]
    assert rel_err(taken, want) > 1e-3


def test_expert_parallel_drops_reach_the_counter_at_flush():
    """The expert-parallel path adds its dropped copies up on the device:
    the ``moe.dropped`` counter moves only at ``flush_dropped``, by the
    layers' ``MoEStats.dropped``; the dense path adds nothing to flush."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import ModelConfig
    from repro_torch.sharding import make_rules, use_rules
    cfg = ModelConfig(name="m", family="moe", num_layers=1, d_model=32,
                      num_heads=2, num_kv_heads=2, d_ff=0, moe_d_ff=16,
                      num_experts=8, experts_per_token=2, vocab_size=64,
                      dtype="float32", remat=False, capacity_factor=0.5)
    p = build_model(cfg, device="cpu").init(0)["blocks"][0]["moe"]
    x = torch.randn((4, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(9))
    before = moe_lib.flush_dropped()
    mesh = make_mesh((2, 4), ("data", "model"))
    with use_rules(make_rules(mesh), mesh), torch.no_grad():
        stats = [moe_lib.moe_ffn(p, x, cfg)[1] for _ in range(2)]
    dropped = sum(int(s.dropped) for s in stats)
    assert dropped > 0
    assert METRICS.counter("moe.dropped").value == before
    assert moe_lib.flush_dropped() == before + dropped
    with torch.no_grad():
        moe_lib.moe_ffn(p, x, cfg)                  # the dense path
    assert moe_lib.flush_dropped() == before + dropped
