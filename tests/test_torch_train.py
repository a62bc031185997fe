"""The port's training (``repro_torch/train/``, ``launch/train.py``)
against the reference.

* The reference's ``tests/test_trainer.py`` cases through the port:
  convergence, restart after injected failures, resume from the
  checkpoint and not from zero; and the same 30 steps through both
  packages on carried-across weights.
* ``tests/test_models_smoke.py::test_smoke_train_step`` over every
  ``ARCH_IDS``: the reference's jitted ``make_train_step`` and the
  port's on the same weights (``params_from_numpy``) and batches (numpy
  from a seed), 3 AdamW steps: loss and every parameter within 1e-5 in
  f32, the grad norm within 1e-5 of itself.  The two recurrent families
  hold the grad norm to 1e-4 of itself and the parameters to 3e-5: on
  identical parameters their f32 gradients differ from the reference's
  by up to 1.5e-5 of a leaf's norm (hymba's chunked SSM scan, xlstm's
  stabilized mLSTM chunks: the summation order of the recurrences;
  measured on the CPU), AdamW's normalized step carries that into the
  parameters where an element's moments nearly cancel (hymba: one
  embedding element 1.05e-5 apart after 3 steps, 1% of a step of lr
  1e-3), and the parameters a little apart give the next steps' norms
  (hymba's 9.8026 vs 9.8021 at step 3, 4.9e-5 of itself).
  One class of element is held to AdamW's own step
  size instead: where a step's gradient is below ``GRAD_FLOOR`` (1e-6),
  AdamW's update ``lr * g / (|g| + eps)`` (eps 1e-8) magnifies a gradient
  difference by up to ``lr / eps`` = 1e5, so the two libraries' f32
  rounding of a near-cancelling sum (1e-10 absolute) moves such an
  element by 1e-5 (kimi's smoke step 1: one embedding element with a
  gradient of -1.07e-9 in the reference and -0.92e-9 in the port, 1.2e-5
  apart after 3 steps, while every gradient agrees within 1e-6 relative
  to its leaf's largest).
* The same 3 steps of hymba's smoke config with the SSM scan's kernel
  route forced on the CPU (the autograd Function ``SSMScan``: the plain
  forward and the backward kernel's plain version, ``ssm_scan_bwd_ref``),
  with the port's remat off and on, at the hybrid family's limits.
* ``launch/train.py --smoke --device cpu`` runs and prints the
  reference's ``loss a -> b`` line.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as R_get_smoke_config
from repro.models import build_model as R_build_model
from repro.models.common import ModelConfig as R_ModelConfig
from repro.optim import adamw as R_adamw
from repro.optim.schedule import constant as R_constant
from repro.train import StepConfig as R_StepConfig
from repro.train import init_train_state as R_init_train_state
from repro.train import make_train_step as R_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssm_scan import backward as ssm_backward
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
from repro_torch.launch import train as T_launch
from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw, named_tree
from repro_torch.optim.schedule import constant
from repro_torch.train import (FailureInjector, StepConfig, Trainer,
                               TrainerConfig, TrainState, init_train_state,
                               make_eval_step, make_serve_steps,
                               make_train_step)

KW = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=2,
          num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
          remat=False)
CFG = ModelConfig(**KW)
TOL = 1e-5
GRAD_FLOOR = 1e-6
#: The recurrent families' limits (see the note): the grad norm's,
#: relative to itself, and the parameters'.
GRAD_NORM_REL = {"hybrid": 1e-4, "ssm": 1e-4}
PARAM_TOL = {"hybrid": 3e-5, "ssm": 3e-5}


def _fixed_batches(device="cpu"):
    fixed = []
    for i in range(4):        # small cycling set -> memorizable signal
        t = np.random.default_rng(i).integers(0, 64, (4, 16)).astype(
            np.int32)
        fixed.append({"tokens": t, "labels": np.roll(t, -1, 1)})
    return fixed


def _setup(tmp_path, fail_at=None, total=30):
    model = build_model(CFG, device="cpu")
    opt = adamw()
    state = init_train_state(model, opt, 0)
    step = make_train_step(model, opt, constant(1e-3), StepConfig())
    fixed = [{k: torch.from_numpy(v) for k, v in b.items()}
             for b in _fixed_batches()]
    mgr = CheckpointManager(str(tmp_path), keep=2)
    return Trainer(step, state, None, mgr,
                   TrainerConfig(total_steps=total, checkpoint_every=10,
                                 log_every=5),
                   injector=FailureInjector(fail_at=fail_at),
                   batch_fn=lambda i: fixed[i % len(fixed)])


def test_loss_decreases(tmp_path):
    tr = _setup(tmp_path)
    tr.run()
    losses = [h["loss"] for h in tr.history]
    assert losses[-1] < losses[0]


def test_restart_after_failure_reaches_total(tmp_path):
    tr = _setup(tmp_path, fail_at=[15, 25])
    final = tr.run()
    assert int(final.step) == 30
    assert tr.restarts == 2


def test_restart_resumes_from_checkpoint_not_zero(tmp_path):
    tr = _setup(tmp_path, fail_at=[15])
    final = tr.run()
    # checkpoint at 10 -> failure at 15 -> restart trains 10..30
    assert int(final.step) == 30
    assert tr.restarts == 1
    logged = [h["step"] for h in tr.history]
    assert logged.count(15) == 2 and 5 in logged and logged[-1] == 30


def test_replay_after_restart_equals_the_uninterrupted_run(tmp_path):
    """Failures at 15 and 25 replay from the checkpoints at 10 and 20:
    the final parameters equal an uninterrupted run's bit for bit."""
    a = _setup(tmp_path / "a").run()
    b = _setup(tmp_path / "b", fail_at=[15, 25]).run()
    pa, pb = named_tree(a.params), named_tree(b.params)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


def test_a_failure_that_is_not_injected_is_not_replayed(tmp_path):
    """Only the injector's failure restarts the loop: an error from the
    step itself (which may have updated the parameters in place) reaches
    the caller at once, with no restart and no further step."""
    tr = _setup(tmp_path)
    step, calls = tr.train_step, []

    def failing(state, batch):
        calls.append(int(state.step))
        if len(calls) == 3:
            raise RuntimeError("CUDA error: an illegal memory access")
        return step(state, batch)

    tr.train_step = failing
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tr.run()
    assert tr.restarts == 0 and calls == [0, 1, 2]


def test_injected_failure_before_a_checkpoint_replays_the_step(tmp_path):
    """With no checkpoint yet, an injected failure (raised before its
    step runs) replays from the untouched state: the run equals an
    uninterrupted one bit for bit."""
    a = _setup(tmp_path / "a", total=8).run()
    tr = _setup(tmp_path / "b", fail_at=[5], total=8)
    b = tr.run()
    assert tr.restarts == 1 and int(b.step) == 8
    pa, pb = named_tree(a.params), named_tree(b.params)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


def _state_pair(r_cfg, t_cfg, seed=0):
    """The reference's train state and the port's on the same weights."""
    r_state = R_init_train_state(R_build_model(r_cfg), R_adamw(),
                                 jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, r_state.params)
    params = params_from_numpy(tree, t_cfg, device="cpu").trainable()
    t_state = TrainState(params=params, opt_state=adamw().init(params),
                         step=torch.zeros((), dtype=torch.int32))
    return r_state, t_state


def _params_close(r_params, t_params, t_cfg, tol=TOL, floor=None,
                  floor_tol=0.0):
    """Every parameter within ``tol``; elements in ``floor`` (a leaf name
    -> bool mask) within ``floor_tol``."""
    want = named_tree(params_from_numpy(jax.tree.map(np.asarray, r_params),
                                        t_cfg, device="cpu"))
    got = named_tree(t_params)
    assert set(want) == set(got)
    def worst(x):
        return float(x.max()) if x.numel() else 0.0

    for k in want:
        diff = (want[k] - got[k].detach()).abs()
        if floor is not None:
            assert worst(diff[floor[k]]) <= floor_tol, k
            diff = diff[~floor[k]]
        assert worst(diff) <= tol, (k, worst(diff))


def test_trainer_history_matches_reference():
    """The reference's trainer setup, 30 steps on the cycling batches
    through both packages on the same weights: every logged loss and
    grad norm, and the final parameters, within 1e-5."""
    r_state, t_state = _state_pair(R_ModelConfig(**KW), CFG)
    r_step = jax.jit(R_make_train_step(R_build_model(R_ModelConfig(**KW)),
                                       R_adamw(), R_constant(1e-3),
                                       R_StepConfig()))
    t_step = make_train_step(build_model(CFG, device="cpu"), adamw(),
                             constant(1e-3), StepConfig())
    fixed = _fixed_batches()
    for i in range(30):
        b = fixed[i % 4]
        r_state, rm = r_step(r_state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        t_state, tm = t_step(t_state, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(rm[k]) - float(tm[k])) <= TOL, (i, k)
    _params_close(r_state.params, t_state.params, CFG)
    assert int(t_state.step) == 30


def _smoke_batch(cfg, seed, b=2, s=16):
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32),
        "labels": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = r.normal(size=(b, cfg.encoder_seq, cfg.d_model)
                                   ).astype(np.float32)
    if cfg.family == "vlm" and cfg.num_patches:
        batch["patch_embeds"] = r.normal(
            size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step_matches_reference(arch):
    _smoke_train_steps_match_reference(arch)


@pytest.mark.parametrize("remat", [False, True], ids=["remat off",
                                                      "remat on"])
def test_hymba_train_step_through_the_scan_kernel_matches_reference(
        monkeypatch, remat):
    """hymba's smoke config with the SSM scan's kernel route forced on
    the CPU: ``SSMScan`` (the plain forward, then ``ssm_scan_bwd_ref``, the
    backward kernel's plain version) gives the reference's train steps at
    the hybrid family's limits above.  With remat on (the port's only;
    the reference's smoke config keeps it off), each layer's scan runs
    again in the backward and is differentiated once."""
    bwd_calls = []

    def counted(*args):
        bwd_calls.append(args[0].shape)
        return ssm_scan_bwd_ref(*args)

    monkeypatch.setattr(ssm_lib, "resolve_scan_impl", lambda device:
                        "kernel")
    monkeypatch.setattr(ssm_backward, "ssm_scan_bwd_ref", counted)
    _smoke_train_steps_match_reference("hymba-1.5b", remat=remat)
    cfg = get_smoke_config("hymba-1.5b")
    assert len(bwd_calls) == 3 * cfg.num_layers


def _smoke_train_steps_match_reference(arch, **port_overrides):
    """3 AdamW steps of ``arch``'s smoke config through both packages on
    the same weights and batches (see the module's note); the port's
    config takes ``port_overrides``."""
    r_cfg, t_cfg = R_get_smoke_config(arch), get_smoke_config(arch)
    t_cfg = t_cfg.scaled(**port_overrides)
    r_state, t_state = _state_pair(r_cfg, t_cfg)
    r_step = jax.jit(R_make_train_step(R_build_model(r_cfg), R_adamw(),
                                       R_constant(1e-3), R_StepConfig()))
    t_step = make_train_step(build_model(t_cfg, device="cpu"), adamw(),
                             constant(1e-3), StepConfig())
    before = {k: v.detach().clone()
              for k, v in named_tree(t_state.params).items()}
    r_model = R_build_model(r_cfg)
    floor = {k: torch.zeros_like(v, dtype=torch.bool)
             for k, v in before.items()}
    for i in range(3):
        b = _smoke_batch(t_cfg, seed=i)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        # the reference's own gradients this step: where one is below the
        # floor, AdamW's step is ill-conditioned (see the module's note)
        f = _floor(r_model, r_state.params, jb, t_cfg)
        floor = {k: floor[k] | f[k] for k in floor}
        r_state, rm = r_step(r_state, jb)
        t_state, tm = t_step(t_state, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        assert np.isfinite(float(tm["loss"])), arch
        assert np.isfinite(float(tm["grad_norm"])), arch
        assert abs(float(rm["loss"]) - float(tm["loss"])) <= TOL, (
            arch, i, float(rm["loss"]), float(tm["loss"]))
        rel = GRAD_NORM_REL.get(t_cfg.family, TOL)
        assert abs(float(rm["grad_norm"]) - float(tm["grad_norm"])) <= \
            rel * float(rm["grad_norm"]), (arch, i, float(rm["grad_norm"]),
                                           float(tm["grad_norm"]))
    assert int(t_state.step) == 3
    # an element under the floor moves at most lr (1 + weight decay) a
    # step in either package
    _params_close(r_state.params, t_state.params, t_cfg,
                  tol=PARAM_TOL.get(t_cfg.family, TOL), floor=floor,
                  floor_tol=3 * 2.2e-3)
    moved = any(not torch.equal(before[k], v)
                for k, v in named_tree(t_state.params).items())
    assert moved, arch


def _floor(r_model, r_params, jb, t_cfg, microbatch=1):
    """Where the reference's gradient of this step (the mean over its
    microbatches) is below GRAD_FLOOR, by port leaf name."""
    def loss(p):
        parts = [r_model.loss(p, {k: v.reshape(microbatch, -1,
                                               *v.shape[1:])[i]
                                  for k, v in jb.items()})[0]
                 for i in range(microbatch)]
        return sum(parts) / microbatch
    g = jax.grad(loss)(r_params)
    g = named_tree(params_from_numpy(jax.tree.map(np.asarray, g), t_cfg,
                                     device="cpu"))
    return {k: v.abs() < GRAD_FLOOR for k, v in g.items()}


def test_microbatch_accumulation_matches_reference():
    r_model = R_build_model(R_ModelConfig(**KW))
    r_state, t_state = _state_pair(R_ModelConfig(**KW), CFG, seed=1)
    r_step = jax.jit(R_make_train_step(r_model, R_adamw(), R_constant(1e-3),
                                       R_StepConfig(microbatch=2)))
    t_step = make_train_step(build_model(CFG, device="cpu"), adamw(),
                             constant(1e-3), StepConfig(microbatch=2))
    floor = None
    for b in _fixed_batches()[:2]:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        f = _floor(r_model, r_state.params, jb, CFG, microbatch=2)
        floor = f if floor is None else {k: floor[k] | f[k] for k in f}
        r_state, rm = r_step(r_state, jb)
        t_state, tm = t_step(t_state, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        assert set(tm) == set(rm)
        for k in rm:
            assert abs(float(rm[k]) - float(tm[k])) <= TOL, k
    _params_close(r_state.params, t_state.params, CFG, floor=floor,
                  floor_tol=2 * 2.2e-3)


@pytest.mark.parametrize("sync", ["mare_tree", "hierarchical"])
def test_multi_card_grad_syncs_name_their_roadmap_item(sync):
    """The mesh's gradient syncs without a mesh: ``mare_tree`` raises
    (the reference asserts a mesh), ``hierarchical`` is the fused step,
    as the reference's; ``tests/test_torch_distributed.py`` runs both on
    meshes against the reference."""
    model = build_model(CFG, device="cpu")
    if sync == "mare_tree":
        with pytest.raises(ValueError, match="needs a mesh"):
            make_train_step(model, adamw(), constant(1e-3),
                            StepConfig(grad_sync=sync))
        return
    b = {k: torch.from_numpy(v) for k, v in _fixed_batches()[0].items()}
    got, gm = make_train_step(model, adamw(), constant(1e-3), StepConfig(
        grad_sync=sync))(init_train_state(model, adamw(), 0), b)
    want, wm = make_train_step(model, adamw(), constant(1e-3),
                               StepConfig())(
        init_train_state(model, adamw(), 0), b)
    assert float(gm["loss"]) == float(wm["loss"])
    assert all(torch.equal(named_tree(want.params)[k], v)
               for k, v in named_tree(got.params).items())
    with pytest.raises(ValueError):
        make_train_step(model, adamw(), constant(1e-3),
                        StepConfig(grad_sync="ring"))


def test_eval_and_serve_steps_take_no_gradients():
    model = build_model(CFG, device="cpu")
    state = init_train_state(model, adamw(), 0)
    b = {k: torch.from_numpy(v) for k, v in _fixed_batches()[0].items()}
    metrics = make_eval_step(model)(state.params, b)
    assert metrics["loss"].grad_fn is None
    prefill, decode = make_serve_steps(model, max_len=20)
    logits, cache = prefill(state.params, b)
    assert logits.grad_fn is None and logits.shape == (4, 16, 64)
    lg, _ = decode(state.params, cache, b["tokens"][:, -1])
    assert lg.grad_fn is None and lg.shape == (4, 64)


def test_serving_params_hold_no_gradients():
    params = build_model(CFG, device="cpu").init(0)
    assert not any(p.requires_grad for p in params.parameters())
    assert all(p.requires_grad for p in params.trainable().parameters())


def test_launch_train_smoke_prints_the_reference_loss_line(tmp_path,
                                                           capsys):
    argv = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "2", "--history-out",
            str(tmp_path / "h.json")]
    assert T_launch.main(argv + ["--steps", "4"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"loss \d+\.\d{4} -> \d+\.\d{4}", out[-1]), out[-1]
    assert sorted(CheckpointManager(str(tmp_path)).latest_steps()) == [2, 4]
    # resume from the last checkpoint and train on to step 6
    assert T_launch.main(argv + ["--steps", "6", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "[trainer] step 6 " in out
    assert "[trainer] step 2 " not in out


def test_launch_train_batches_follow_the_reference_rule():
    cfg = get_smoke_config("whisper-base")
    b = T_launch.make_batch_fn(cfg, 2, 8, seed=3,
                               device=torch.device("cpu"))(5)
    r = np.random.default_rng(3 * 100003 + 5)
    tokens = r.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    np.testing.assert_array_equal(b["tokens"].numpy(), tokens)
    np.testing.assert_array_equal(b["labels"].numpy(),
                                  np.roll(tokens, -1, axis=1))
    frames = r.normal(size=(2, cfg.encoder_seq, cfg.d_model))
    np.testing.assert_allclose(b["frames"].numpy(), frames, rtol=1e-6)


def test_launch_train_defaults_to_cuda():
    argv = ["--arch", "llama3.2-1b", "--smoke", "--steps", "1"]
    if torch.cuda.is_available():
        assert T_launch.parser().parse_args(argv).device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T_launch.main(argv)
