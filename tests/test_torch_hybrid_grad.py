"""hymba's f32 gradients against float64, in both packages.

On the card, hymba's f32 gradients through the SSM kernels sat 5e-5 to
3e-4 (relative norm, leaf by leaf) from a float64 scan, the worst leaf
``ssm.x_proj``, with nothing to say whether the reference sits as far.
This test settles it on the CPU: the reference's own 2-layer hymba (one
global and one windowed layer) takes ``jax.grad`` in float32 and in
float64 (``jax_enable_x64``, every ``jnp.float32`` of the model read as
float64), and the port's f32 gradients on the same weights and tokens
(its CPU route: the chunked scan, ``attn_impl="ref"``) are held to the
same float64 numbers.  Both run in one subprocess that reports only the
distances, for each of several seeds of weights and tokens.

Each op of the SSM path is as accurate in the port as in the reference
(each package's SSM block, given the model's own inputs and output
gradient, lies as close to float64); what differs is which rounding the
deep backward amplifies.  So each package's worst leaf scatters over the
seeds by 4x and more, and neither is always the closer.  The port must
lie no farther from float64 than the reference up to that scatter: its
mean worst-leaf distance over the seeds within ``SCATTER`` of the
reference's.  The test runs at a quarter of hymba's width, a 512-token
sequence and eight seeds (3.6 GB, about a minute); ``run`` takes the full
width too (``run(1, 1152, range(4), {})``, 22 GB of host memory).
"""
import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SEEDS = tuple(range(8))
BATCH, SEQ = 1, 512
#: The cut of hymba's width that keeps the test near 3.6 GB of host
#: memory (heads, head dim, SSM state and chunk, vocabulary and window
#: stay).
QUARTER = {"d_model": 400, "d_ff": 1376}
#: The port's mean worst-leaf distance may exceed the reference's by this
#: factor: each package's own spread over the seeds is 4x and more.
SCATTER = 2.0
CARD_LIMIT = 1e-4

SCRIPT = textwrap.dedent("""
    import gc, json, os, resource, sys
    # at most 4 cores: the suite's other workers time their own code
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:4])
    import numpy as np
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as R_get_config
    from repro.models import build_model as R_build_model
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import named_tree
    b, s = int(sys.argv[1]), int(sys.argv[2])
    seeds = json.loads(sys.argv[3])
    cut = dict(num_layers=2, global_layers=(0,), dtype="float32",
               attn_impl="ref", remat=False, **json.loads(sys.argv[4]))
    cfg = R_get_config("hymba-1.5b").scaled(**cut)
    tcfg = get_config("hymba-1.5b").scaled(**cut)
    model = R_build_model(cfg)
    grad32 = jax.jit(jax.grad(lambda p, bt: model.loss(p, bt)[0]))
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64          # the model's f32 casts too
        try:
            m64 = R_build_model(cfg.scaled(dtype="float64"))
            grad64 = jax.jit(jax.grad(lambda p, bt: m64.loss(p, bt)[0]))
        finally:
            jnp.float32 = f32
    port = build_model(tcfg, device="cpu")
    out = {}
    for seed in seeds:
        params = jax.tree.map(np.asarray, jax.jit(model.init)(
            jax.random.PRNGKey(seed)))
        r = np.random.default_rng(seed)
        tok = r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
        g32 = grad32(params, jax.tree.map(jnp.asarray, batch))
        with jax.enable_x64(True):
            jnp.float32 = jnp.float64
            try:
                g64 = grad64(jax.tree.map(lambda a: jnp.asarray(
                    a, jnp.float64), params), jax.tree.map(jnp.asarray,
                                                           batch))
                g64 = jax.tree.map(lambda a: np.asarray(a, np.float64), g64)
            finally:
                jnp.float32 = f32
        tp = params_from_numpy(params, tcfg, device="cpu").trainable()
        loss, _ = port.loss(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        loss.backward()
        got = {"port": {k: p.grad for k, p in tp.named_parameters()},
               "ref": named_tree(params_from_numpy(
                   jax.tree.map(np.asarray, g32), tcfg, device="cpu"))}
        want = {k: v.double() for k, v in named_tree(params_from_numpy(
            g64, tcfg.scaled(dtype="float64"), device="cpu")).items()}
        out[seed] = {side: {k: float((g[k].double() - want[k]).norm()
                                     / want[k].norm()) for k in want}
                     for side, g in got.items()}
        del params, g32, g64, tp, loss, got, want
        gc.collect()
    out["maxrss_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(json.dumps(out))
""")


def run(batch, seq, seeds, overrides):
    """Each seed's {"ref": {leaf: distance}, "port": {...}} from float64
    (relative norm), and the subprocess's peak resident kB."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    env["JAX_PLATFORMS"] = "cpu"
    env["MALLOC_ARENA_MAX"] = "2"
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(batch), str(seq),
         json.dumps(list(seeds)), json.dumps(overrides)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    return {int(k): v for k, v in res.items() if k != "maxrss_kb"}, \
        res["maxrss_kb"]


def test_port_f32_gradients_no_farther_from_f64_than_the_reference():
    res, rss = run(BATCH, SEQ, SEEDS, QUARTER)
    worst = {side: [max(res[seed][side].values()) for seed in SEEDS]
             for side in ("ref", "port")}
    mean = {side: sum(w) / len(w) for side, w in worst.items()}
    print(json.dumps({"worst_leaf_by_seed": worst, "mean": mean,
                      "maxrss_kb": rss}))
    for seed in SEEDS:
        assert set(res[seed]["ref"]) == set(res[seed]["port"])
    assert mean["port"] <= SCATTER * mean["ref"], mean
    assert max(max(w) for w in worst.values()) < CARD_LIMIT, worst
