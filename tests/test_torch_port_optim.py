"""The port's optimizer side against the JAX package's, on the CPU in fp32.

``mirror_tpu_torch.train.optim.make_optimizer`` (every ``--opt``, weight
decay on and off, amsgrad, the ``--opt-kwargs``, the linear probe's
head-only freezing, the three clip modes) runs 5 updates of a small
parameter set on fixed gradients beside the JAX ``make_optimizer`` chain:
the parameters within 1e-6 of each tensor's scale, and their displacement
within 1e-5 of its own (or two fp32 ulp of the tensor). The same parameters
go through both packages' layouts (flax kernels [in, out] and HWIO, the
port's [out, in] and OIHW, by ``convert.state_dict_from_jax``), so the
unit-wise AGC norms and the head exclusion are held too.

Also: every schedule's lr at each update count against the JAX
``make_schedule`` (cycles, k-decay, warmup prefix, multistep's early decay,
noise) and ``scheduled_epochs``; the plateau controller's epoch lrs over a
metric sequence; the EMA's decay ramp; gradient accumulation (k = 2 over 4
micro-batches) with the EMA and the logged lr against ``optax.MultiSteps``
and the JAX step's ``_apply_updates``; the accumulation counter carried
across an epoch boundary by the harness; ``--layer-decay`` inert and
logged.
"""

import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from mirror_tpu.train import optim as jax_optim
from mirror_tpu.train import steps as jax_steps
from mirror_tpu.train.state import create_train_state
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.train import harness
from mirror_tpu_torch.train import optim
from mirror_tpu_torch.train.steps import ModelEma, ema_decay_at
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

LR = 0.1


def _flax_params(seed: int, scale: float = 1.0) -> dict:
    """A flax-layout tree with each kind of leaf the models have: a dense
    kernel and bias, a depthwise conv kernel (HWIO), a LayerNorm, a bare
    token and the classifier head."""
    rng = np.random.default_rng(seed)
    tree = {"enc": {"kernel": rng.standard_normal((6, 5)), "bias": rng.standard_normal(5)},
            "conv": {"kernel": rng.standard_normal((3, 3, 1, 4)),
                     "bias": rng.standard_normal(4)},
            "norm": {"scale": 1 + 0.1 * rng.standard_normal(5), "bias": rng.standard_normal(5)},
            "cls_token": rng.standard_normal((1, 1, 5)),
            "head": {"kernel": rng.standard_normal((5, 3)), "bias": rng.standard_normal(3)}}
    return jax.tree.map(lambda a: np.asarray(a * scale, np.float32), tree)


def _module(state: dict) -> nn.Module:
    """An nn.Module whose parameters are ``state``'s, under its keys."""
    root = nn.Module()
    for key, val in state.items():
        *path, leaf = key.split(".")
        mod = root
        for name in path:
            if not hasattr(mod, name):
                mod.add_module(name, nn.Module())
            mod = getattr(mod, name)
        mod.register_parameter(leaf, nn.Parameter(torch.tensor(np.array(val))))
    return root


def _args(**kw):
    base = dict(opt="adam", opt_eps=None, opt_betas=None, opt_kwargs={}, momentum=0.9,
                weight_decay=0.0, clip_grad=None, clip_mode="norm", layer_decay=None,
                use_sched=False, sched="cosine", sched_on_updates=False, grad_accum_steps=1,
                epochs=10, warmup_epochs=0, decay_epochs=3, decay_milestones=(3, 6),
                warmup_lr=1e-5, min_lr=1e-6, decay_rate=0.5, warmup_prefix=False,
                lr_cycle_mul=1.0, lr_cycle_decay=0.5, lr_cycle_limit=1, lr_k_decay=1.0,
                cooldown_epochs=0, lr_noise=None, lr_noise_pct=0.67, lr_noise_std=1.0,
                seed=42, patience_epochs=10, model_ema_decay=0.9998, model_ema_warmup=False)
    base.update(kw)
    return SimpleNamespace(**base)


def _set_grads(module: nn.Module, flax_grads: dict) -> None:
    named = dict(module.named_parameters())
    for key, val in state_dict_from_jax(flax_grads).items():
        named[key].grad = torch.tensor(np.array(val))


def _assert_close(module: nn.Module, flax_params: dict, start: dict, what: str) -> None:
    named = dict(module.named_parameters())
    init = state_dict_from_jax(start)
    for key, want in state_dict_from_jax(jax.device_get(flax_params)).items():
        got = named[key].detach().numpy()
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= 1e-6 * scale, f"{what} {key}: params"
        moved = want - init[key]
        bar = max(1e-5 * np.abs(moved).max(), 2.5e-7 * scale)  # 2 ulp of the tensor
        assert np.abs((got - init[key]) - moved).max() <= bar, f"{what} {key}: displacement"


# (id, make_optimizer flags, linear probe, gradient scale)
CHAINS = [(f"{opt}-wd{wd}", dict(opt=opt, weight_decay=wd), False, 3.0)
          for opt in optim.OPTIMIZERS for wd in (0.0, 0.05)]
CHAINS += [
    ("adam-amsgrad", dict(opt="adam", opt_kwargs={"amsgrad": True}), False, 3.0),
    ("adamw-amsgrad-wd", dict(opt="adamw", weight_decay=0.05, opt_kwargs={"amsgrad": True}),
     False, 3.0),
    ("adam-opt-kwargs", dict(opt="adam", opt_kwargs={"eps": 1e-3, "betas": (0.8, 0.99)}),
     False, 3.0),
    ("nesterov-kwargs-momentum", dict(opt="nesterov", opt_kwargs={"momentum": 0.5}), False,
     3.0),
    ("rmsprop-alpha-no-momentum", dict(opt="rmsprop", opt_kwargs={"alpha": 0.95},
                                       momentum=0.0), False, 3.0),
    ("adagrad-eps", dict(opt="adagrad", opt_eps=1e-3, weight_decay=0.05), False, 3.0),
    ("adam-probe", dict(opt="adam", weight_decay=0.05), True, 3.0),
    ("sgd-probe", dict(opt="sgd", weight_decay=0.05), True, 3.0),
    ("lamb-probe-clip", dict(opt="lamb", clip_grad=1.0), True, 3.0),
    ("adam-clip-norm-above", dict(opt="adam", clip_grad=1.0), False, 3.0),
    ("sgd-clip-norm-below", dict(opt="sgd", clip_grad=100.0), False, 3.0),
    ("sgd-clip-value", dict(opt="sgd", clip_grad=0.5, clip_mode="value"), False, 3.0),
    ("sgd-clip-agc", dict(opt="sgd", clip_grad=0.05, clip_mode="agc"), False, 3.0),
    ("lamb-clip-agc-small-grads", dict(opt="lamb", clip_grad=0.01, clip_mode="agc",
                                       weight_decay=0.05), False, 0.005),
]


@pytest.mark.parametrize("flags,probe,grad_scale", [c[1:] for c in CHAINS],
                         ids=[c[0] for c in CHAINS])
def test_optimizer_matches_the_jax_chain(flags, probe, grad_scale):
    args = _args(**flags)
    params = _flax_params(0)
    grads = [_flax_params(10 + t, grad_scale) for t in range(5)]
    mask = ({k: jax.tree.map(lambda _, k=k: k == "head", v) for k, v in params.items()}
            if probe else None)
    tx = jax_optim.make_optimizer(args, jax_optim.make_schedule(args, 1, LR),
                                  trainable_mask=mask)
    state, p = tx.init(params), params
    for g in grads:
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)

    module = _module(state_dict_from_jax(params))
    opt = optim.make_optimizer(args, module, LR, head_only=probe)
    for g in grads:
        _set_grads(module, g)
        assert opt.step()
    _assert_close(module, p, params, str(flags))
    if probe:
        np.testing.assert_array_equal(module.enc.weight.detach().numpy(),
                                      np.asarray(params["enc"]["kernel"]).T)


def test_agc_leaves_the_head_alone_and_clips_the_rest():
    """AGC at a bar every unit is over: the head's update is the unclipped
    SGD step (timm's exclusion of the last two parameters), every other
    leaf moved less than unclipped SGD would move it."""
    args = _args(opt="sgd", momentum=0.0, clip_grad=1e-3, clip_mode="agc")
    params, g = _flax_params(0), _flax_params(1, 10.0)
    module = _module(state_dict_from_jax(params))
    before = {k: v.detach().clone() for k, v in module.named_parameters()}
    opt = optim.make_optimizer(args, module, LR)
    _set_grads(module, g)
    opt.step()
    for name, p in module.named_parameters():
        step = (before[name] - p.detach()).abs().max()
        full = (LR * p.grad).abs().max()
        if name.startswith("head."):
            assert torch.allclose(step, full), name
        else:
            assert step < 0.1 * full, name


def test_unknown_opt_kwargs_and_optimizers_are_refused_as_jax_refuses_them():
    module = _module(state_dict_from_jax(_flax_params(0)))
    bad = _args(opt_kwargs={"foo": 1})
    with pytest.raises(ValueError, match="foo"):
        jax_optim.make_optimizer(bad, jax_optim.make_schedule(bad, 1, LR))
    with pytest.raises(ValueError, match="foo"):
        optim.make_optimizer(bad, module, LR)
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        optim.make_optimizer(_args(opt="adafactor"), module, LR)


# (id, schedule flags); steps_per_epoch 3, base lr 3e-3
SCHEDULES = [
    ("cosine-warmup", dict(warmup_epochs=2)),
    ("cosine-on-updates", dict(sched_on_updates=True, warmup_epochs=2)),
    ("cosine-cycles", dict(lr_cycle_mul=1.1, lr_cycle_limit=3, lr_cycle_decay=0.7)),
    ("cosine-kdecay-prefix-cooldown", dict(lr_k_decay=0.5, warmup_prefix=True, warmup_epochs=2,
                                           lr_cycle_limit=2, cooldown_epochs=2)),
    ("tanh-cycles", dict(sched="tanh", lr_cycle_limit=2, warmup_epochs=1)),
    ("poly-kdecay", dict(sched="poly", sched_on_updates=True, lr_k_decay=2.0)),
    ("step", dict(sched="step", warmup_epochs=1)),
    ("multistep-quirk", dict(sched="multistep", sched_on_updates=True)),
    ("cosine-noise-window", dict(lr_noise=[0.3, 0.8], sched_on_updates=True)),
    ("step-noise-from", dict(sched="step", lr_noise=[0.5], lr_noise_std=0.5)),
    ("plateau-constant", dict(sched="plateau")),
    ("no-sched", dict(use_sched=False)),
]


@pytest.mark.parametrize("flags", [s[1] for s in SCHEDULES], ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax_at_every_update(flags):
    spe, base = 3, 3e-3
    args = _args(**{"use_sched": True, **flags})
    jax_fn = jax.jit(jax_optim.make_schedule(args, spe, base))
    ours = optim.make_schedule(args, spe, base)
    n = (jax_optim.scheduled_epochs(args) + 2) * spe
    want = np.array([float(jax_fn(jnp.int32(t))) for t in range(n)])
    got = np.array([ours(t) for t in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * base)
    assert optim.scheduled_epochs(args) == jax_optim.scheduled_epochs(args)


def test_multistep_decays_one_epoch_early_and_cycles_restart_exactly():
    """Two quirks the JAX package keeps: multistep's decay lands at epoch
    m - 1; a 1.1x-growing cosine restarts at epoch 21 of 10 + 11 (the fp64
    cycle starts), not one epoch later."""
    multi = optim.make_schedule(_args(use_sched=True, sched="multistep"), 1, 1.0)
    assert [multi(t) for t in (1, 2, 5)] == [1.0, 0.5, 0.25]
    cyc = optim.make_schedule(_args(use_sched=True, lr_cycle_mul=1.1, lr_cycle_limit=3,
                                    lr_cycle_decay=0.5, min_lr=0.0), 1, 1.0)
    assert cyc(21) == 0.25 and cyc(20) < 0.02


def test_plateau_controller_matches_jax():
    """Epoch lrs over a metric sequence with improvements, plateaus, a
    cooldown, a NaN-free None epoch, warmup and post-warmup noise; the
    optimizer's lr is the controller's applied one."""
    args = _args(use_sched=True, sched="plateau", warmup_epochs=2, patience_epochs=1,
                 cooldown_epochs=1, decay_rate=0.5, lr_noise=[0.5], epochs=12)
    metrics = [1.0, 0.9, 0.8, 0.8, 0.8, 0.79999, 0.7, None, 0.7, 0.7, 0.7, 0.7]
    theirs = jax_optim.PlateauController.from_args(args, 0.01)
    ours = optim.PlateauController.from_args(args, 0.01)
    module = _module(state_dict_from_jax(_flax_params(0)))
    opt = optim.make_optimizer(args, module, 0.01)
    assert opt.current_lr() == pytest.approx(args.warmup_lr, rel=1e-7)
    for epoch, m in enumerate(metrics):
        want = theirs.epoch_lr(epoch, m)
        assert ours.step_epoch(opt, epoch, m) == want
        assert opt.current_lr() == pytest.approx(want, rel=1e-7)
    assert ours.current_lr < 0.01  # it decayed
    maxi = optim.PlateauController.from_args(args, 0.01, decreasing_metric=False)
    assert maxi.mode == "max"


def test_ema_decay_ramp_matches_jax():
    for warmup in (False, True):
        for decay in (0.9998, 0.5):
            got = [ema_decay_at(decay, warmup, n) for n in range(1, 30)]
            want = [float(jax_steps._ema_decay_at(decay, warmup, n)) for n in range(1, 30)]
            np.testing.assert_allclose(got, want, rtol=1e-6)
            assert got[0] == 0.0


@pytest.mark.parametrize("opt,warmup", [("adam", True), ("lamb", False), ("sgd", True)])
def test_accumulation_with_ema_and_lr_matches_multisteps(opt, warmup):
    """k = 2 over 4 micro-batches: the JAX step's ``_apply_updates``
    (MultiSteps around the chain, the EMA once per real update) against
    the port's optimizer and ModelEma; the logged lr at every micro-step
    (the schedule at the real-update count), the parameters and the EMA
    weights after each."""
    args = _args(opt=opt, grad_accum_steps=2, use_sched=True, sched_on_updates=True,
                 warmup_epochs=1, epochs=3, weight_decay=0.05, clip_grad=1.0,
                 model_ema=True, model_ema_decay=0.9, model_ema_warmup=warmup)
    params = _flax_params(0)
    grads = [_flax_params(20 + t, 3.0) for t in range(4)]
    schedule = jax_optim.make_schedule(args, 2, LR)
    tx = jax_optim.make_optimizer(args, schedule)
    state = create_train_state(params, tx, model_ema=True)

    module = _module(state_dict_from_jax(params))
    opt_t = optim.make_optimizer(args, module, LR, steps_per_epoch=2)
    ema = ModelEma(module, args.model_ema_decay, args.model_ema_warmup)
    for t, g in enumerate(grads):
        want_lr = float(jax_steps.applied_lr(state.opt_state, schedule, state.step))
        state = jax_steps._apply_updates(state, g, tx, args.model_ema_decay, warmup)
        assert opt_t.current_lr() == pytest.approx(want_lr, rel=1e-6), f"micro-step {t}"
        _set_grads(module, g)
        if opt_t.step():
            ema.update()
        assert opt_t.mini_step == (t + 1) % 2 and opt_t.count == (t + 1) // 2
        _assert_close(module, state.params, params, f"micro-step {t}")
        _assert_close(ema.module, state.ema_params, params, f"EMA, micro-step {t}")
    assert ema.updates == 2


def test_accumulation_counter_carries_across_epochs():
    """3 batches an epoch at k = 2: the harness runs 2 epochs of the step,
    and the optimizer updates on micro-steps 2, 4 and 6 (MultiSteps'
    counter is not flushed at an epoch's end)."""
    module = _module(state_dict_from_jax(_flax_params(0)))
    opt = optim.make_optimizer(_args(opt="sgd", grad_accum_steps=2), module, LR)
    updated = []

    class Loader:
        def __len__(self):
            return 3

        def __iter__(self):
            return iter([{"wsi": np.zeros((1, 1), np.float32)}] * 3)

        def set_epoch(self, epoch):
            pass

    def step(batch):
        for p in module.parameters():
            p.grad = torch.ones_like(p)
        updated.append(opt.step())
        return {"loss": torch.zeros(()), "lr": opt.current_lr()}

    args = SimpleNamespace(log_interval=10)
    for epoch in range(2):
        metrics = harness.train_one_epoch(args, epoch, step, Loader(), "cpu")
        assert metrics["lr"] == pytest.approx(LR)
    assert updated == [False, True, False, True, False, True]
    assert opt.count == 3 and opt.mini_step == 0


def test_layer_decay_is_inert_and_logged(caplog):
    """--layer-decay leaves every update as it is, in the JAX chain and in
    the port, and logs the JAX package's line."""
    params, grads = _flax_params(0), [_flax_params(30 + t, 3.0) for t in range(3)]
    results = []
    for layer_decay in (None, 0.65):
        args = _args(opt="adamw", weight_decay=0.05, layer_decay=layer_decay)
        tx = jax_optim.make_optimizer(args, jax_optim.make_schedule(args, 1, LR))
        state, p = tx.init(params), params
        for g in grads:
            updates, state = tx.update(g, state, p)
            p = optax.apply_updates(p, updates)
        results.append(jax.device_get(p))
        module = _module(state_dict_from_jax(params))
        with caplog.at_level(logging.INFO, logger=optim.__name__):
            opt = optim.make_optimizer(args, module, LR)
        for g in grads:
            _set_grads(module, g)
            opt.step()
        _assert_close(module, p, params, f"layer_decay {layer_decay}")
    jax.tree.map(np.testing.assert_array_equal, results[0], results[1])
    assert any("layer_decay=0.65" in r.getMessage() and "lr scale 1.0" in r.getMessage()
               for r in caplog.records)
