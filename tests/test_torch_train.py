"""The port's training slice against the JAX package, in float64.

Both sides run in f64 (JAX under ``jax_enable_x64``, the port's model with
``.double()`` and compute dtype float64), as ``tests/test_train_parity.py``
does, so the comparisons are decisive. Weights: the JAX package's seeded
train-tree init (aux heads included) with numpy-randomized BatchNorm
statistics and affines, bridged into the port. Batches:
``test_train_parity._batch`` (2 x 64 x 96 uint8 frames, labels with 10%
ignore), ``no_new_aug``.

Tolerances, each with its reason:

- train-mode forward (logits, aux heads, updated running statistics):
  rtol 1e-9, atol 1e-12 (f64, sums in another order);
- one step, every metric in f64 (``loss_ce``, ``grad_norm``): rel 1e-9;
  ``lr`` rel 1e-6 (the JAX schedule computes in f32); ``loss_lovasz`` and
  the total ``loss`` rel 1e-6: the binned Lovász loss is f32 by design and
  its error sums add in another order;
- parameter deltas: ``test_train_parity._delta_parity`` at 1e-6 (Adam's
  first step is about sign(g), which amplifies relative error on near-zero
  gradients);
- batch statistics after the step: rtol 1e-9, atol 1e-12.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_train_parity import _batch, _delta_parity, _f64  # noqa: I001

from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu.models.factory import build_model as jbuild_model
from rtda_semanticsegmentation_tpu.models.factory import init_model as jinit_model
from rtda_semanticsegmentation_tpu.train.optim import build_generator_tx as jbuild_tx
from rtda_semanticsegmentation_tpu.train.schedule import poly_lr_schedule as jpoly
from rtda_semanticsegmentation_tpu.train.state import ModelState, TrainState as JTrainState
from rtda_semanticsegmentation_tpu.train.steps import make_train_step as jmake_train_step
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, init_model, load_variables
from rtda_semanticsegmentation_tpu_torch.train.optim import build_generator_tx
from rtda_semanticsegmentation_tpu_torch.train.schedule import poly_lr_schedule
from rtda_semanticsegmentation_tpu_torch.train.state import TrainState
from rtda_semanticsegmentation_tpu_torch.train.steps import make_train_step

H, W = 64, 96
MAX_ITER = 100
EXEMPT = ("supervision1", "supervision2")


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _cfgs(mode: str):
    """The JAX and port configs of one source-only mode, f64 compute;
    ``vanilla`` with the watch metrics on (``obs.watch_freq_steps``)."""
    out = []
    for cfgmod in (jconfig, tconfig):
        cfg = cfgmod.get_preset("bisenet_source_small")
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, compute_dtype="float64"),
            augment=dataclasses.replace(cfg.augment, pipeline="no_new_aug"),
            loss=dataclasses.replace(cfg.loss, use_lovasz=mode == "lovasz", lovasz_impl="binned"),
            optimizer=dataclasses.replace(cfg.optimizer, name="adam" if mode == "lovasz" else "sgd"),
            obs=dataclasses.replace(cfg.obs, watch_freq_steps=10 if mode == "vanilla" else 0),
        )
        out.append(cfg)
    return out


def _jax_variables(seed):
    """f64 flat JAX train-tree variables with non-trivial BatchNorms."""
    jcfg, _ = _cfgs("vanilla")
    variables = jinit_model(jbuild_model(jcfg.model), jax.random.PRNGKey(seed), (1, H, W, 3), train=True)
    flat = {k: np.array(v, np.float64) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()}
    rng = np.random.RandomState(seed)
    for k, v in flat.items():
        if k.endswith("/bn/scale"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("/bn/bias"):
            flat[k] = rng.randn(*v.shape) * 0.1
        elif k.endswith("/mean"):
            flat[k] = rng.uniform(-0.5, 0.5, v.shape)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape)
    return flat


def _unflat(flat):
    return flax.traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def _port_model(tcfg, flat):
    model = build_model(tcfg.model, device="cpu", train=True).double()
    load_variables(model, from_jax_variables(flat))
    return model


def _port_flat(model):
    return {k: np.asarray(v, np.float64) for k, v in to_jax_variables(model.state_dict()).items()}


def test_train_forward_matches_jax():
    jcfg, tcfg = _cfgs("vanilla")
    flat = _jax_variables(1)
    x = np.random.RandomState(2).randn(2, H, W, 3)
    (logits, sup1, sup2), mut = jbuild_model(jcfg.model).apply(
        _unflat(flat), jnp.asarray(x), True, mutable=["batch_stats"])
    model = _port_model(tcfg, flat)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2), aux=True)
    for g, w in zip(got, (logits, sup1, sup2)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-9, atol=1e-12)
    want_bs = {f"batch_stats/{k}": np.asarray(v) for k, v in
               flax.traverse_util.flatten_dict(mut["batch_stats"], sep="/").items()}
    got_bs = {k: v for k, v in _port_flat(model).items() if k.startswith("batch_stats/")}
    assert got_bs.keys() == want_bs.keys() and len(want_bs) > 40
    for k, v in want_bs.items():
        np.testing.assert_allclose(got_bs[k], v, rtol=1e-9, atol=1e-12, err_msg=k)
    # without aux the heads are not computed
    with torch.no_grad():
        _, s1, s2 = model(torch.from_numpy(x).permute(0, 3, 1, 2), aux=False)
    assert s1 is None and s2 is None


def _jax_step(jcfg, flat, batch):
    model = jbuild_model(jcfg.model)
    variables = _f64(_unflat(flat))
    g = ModelState.create(model.apply, variables, jbuild_tx(jcfg.optimizer, MAX_ITER, decay_exempt=EXEMPT))
    step = jax.jit(jmake_train_step(jcfg, jpoly(jcfg.optimizer.learning_rate, MAX_ITER)))
    state, metrics = step(JTrainState.create(g), batch, jax.random.PRNGKey(0))
    return state.generator, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("mode", ["lovasz", "vanilla"])
def test_train_step_matches_jax(mode):
    """One ``make_train_step`` update: ``lovasz`` (binned loss, Adam) and
    ``vanilla`` (CE, SGD, with the ``watch/g/<module>/{param,grad}_norm``
    metrics, f64, rel 1e-9), the ``test_train_parity.py`` bars."""
    jcfg, tcfg = _cfgs(mode)
    flat = _jax_variables(3)
    images, labels, _ = _batch(4)
    jgen, jm = _jax_step(jcfg, flat, {"image": jnp.asarray(images), "label": jnp.asarray(labels)})

    model = _port_model(tcfg, flat)
    sched = poly_lr_schedule(tcfg.optimizer.learning_rate, MAX_ITER)
    state = TrainState(model, build_generator_tx(tcfg.optimizer, model, decay_exempt=EXEMPT), sched)
    step = make_train_step(tcfg, sched)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    state, metrics = step(state, batch, torch.Generator())
    assert state.step == 1
    tm = {k: float(v) for k, v in metrics.items()}

    assert tm.keys() == jm.keys()
    assert any(k.startswith("watch/") for k in tm) == (mode == "vanilla")
    for k, v in jm.items():
        rel = 1e-6 if k in ("lr", "loss", "loss_lovasz") else 1e-9
        assert tm[k] == pytest.approx(v, rel=rel, abs=1e-300), k
    if mode == "lovasz":
        assert tm["loss_lovasz"] > 0.1
    ours = _port_flat(model)
    before = {k: v for k, v in flat.items() if k.startswith("params/")}
    _delta_parity(_unflat(before), _unflat({k: ours[k] for k in before}),
                  _unflat({f"params/{k}": np.asarray(v) for k, v in
                           flax.traverse_util.flatten_dict(jgen.params, sep="/").items()}),
                  f"{mode}:", rel_tol=1e-6)
    for k, v in flax.traverse_util.flatten_dict(jgen.batch_stats, sep="/").items():
        np.testing.assert_allclose(ours[f"batch_stats/{k}"], np.asarray(v), rtol=1e-9, atol=1e-12, err_msg=k)


def test_poly_schedule_matches_jax():
    for base, power in ((1e-4, 0.9), (2.5e-4, 0.9), (1e-3, 2.0)):
        port, ref = poly_lr_schedule(base, MAX_ITER, power), jpoly(base, MAX_ITER, power)
        for t in (0, 1, 37, 99, 100, 150):
            assert port(t) == pytest.approx(float(ref(t)), rel=1e-6, abs=1e-12), (base, t)
    with pytest.raises(ValueError):
        poly_lr_schedule(1e-4, 0)


@pytest.mark.parametrize("aux_weight", [0.0, 0.4])
def test_aux_heads_decay_exemption(aux_weight):
    """With ``aux_weight == 0`` the aux heads get no gradient and no decay,
    so they stay at their init; with a weight they train and decay."""
    _, tcfg = _cfgs("vanilla")
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, compute_dtype="float32"),
                        loss=dataclasses.replace(tcfg.loss, aux_weight=aux_weight))
    model = build_model(tcfg.model, device="cpu", train=True)
    init_model(model, torch.Generator().manual_seed(0))
    exempt = () if aux_weight else EXEMPT
    opt = build_generator_tx(tcfg.optimizer, model, decay_exempt=exempt)
    assert [g["weight_decay"] for g in opt.param_groups] == ([1e-4, 0.0] if exempt else [1e-4])
    before = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("supervision")}
    sched = poly_lr_schedule(tcfg.optimizer.learning_rate, MAX_ITER)
    images, labels, _ = _batch(5)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    _, metrics = make_train_step(tcfg, sched)(TrainState(model, opt, sched), batch, torch.Generator())
    moved = [not torch.equal(model.state_dict()[k], v) for k, v in before.items()]
    assert len(moved) == 4 and all(m == bool(aux_weight) for m in moved)
    assert ("loss_aux" in metrics) == bool(aux_weight)
    assert all(model.get_parameter(f"{s}.weight").grad is None for s in EXEMPT) != bool(aux_weight)


def test_unported_modes_raise():
    """What earlier slices left unported is ported now, and builds:
    ``train.remat``, training DeepLabV2 from its preset and its
    frozen-BatchNorm optimizer, which holds every parameter but the
    BatchNorm affines. The watch metrics are ported: a config that asks for
    them builds a step. (The steps themselves: ``tests/test_torch_r101_train.py``.)"""
    _, tcfg = _cfgs("vanilla")
    sched = poly_lr_schedule(1e-4, MAX_ITER)
    assert tcfg.obs.watch_freq_steps > 0 and callable(make_train_step(tcfg, sched))
    assert callable(make_train_step(tcfg.replace(train=tconfig.TrainConfig(remat=True)), sched))
    deeplab = build_model(tconfig.get_preset("deeplabv2_cityscapes").model, device="cpu", train=True)
    assert deeplab.training
    model = build_model(tcfg.model, device="cpu")
    opt = build_generator_tx(tcfg.optimizer, model, freeze_bn=True)
    held = {id(p) for group in opt.param_groups for p in group["params"]}
    names = [n for n, p in model.named_parameters() if id(p) not in held]
    assert names and all(n.rsplit(".", 2)[-2:] in (["bn", "weight"], ["bn", "bias"]) for n in names)
