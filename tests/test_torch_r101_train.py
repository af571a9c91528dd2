"""Training the port's ResNet-101 models against the JAX package, in float64.

Both sides run in f64 (JAX under ``jax_enable_x64``, the port's model with
``.double()`` and compute dtype float64), as ``tests/test_torch_train.py``
does for BiSeNet-R18. Weights: the JAX package's seeded train-tree init with
numpy-randomized BatchNorm statistics and affines, bridged into the port.
Batches: ``test_train_parity._batch`` (2 x 64 x 96 uint8 frames, labels
with 10% ignore). Each JAX model is built, initialised and stepped once per
module.

- ``deeplabv2_cityscapes`` (DeepLabV2, SGD at 2.5e-4, normalization only):
  two steps of the port against two of JAX's ``make_train_step`` with the
  frozen-BatchNorm optimizer (``build_generator_tx(freeze_bn=True)``). The
  second step catches gradients of the frozen affines that pile up from
  step to step (they are outside the optimizer, and ``grad_norm`` counts
  them, as ``optax.global_norm`` does).
- BiSeNet-R101, one ``vanilla`` SGD step.
- ``train.remat`` on against off, on the port alone.

Tolerances, each with its reason:

- ``loss``, ``loss_ce`` and ``grad_norm``: rel 1e-9 (f64, sums in another
  order); ``lr`` rel 1e-6 (the JAX schedule computes in f32);
- parameter deltas: ``test_train_parity._delta_parity`` at 1e-6, the bar of
  ``tests/test_torch_train.py`` (per-leaf errors judged against the step's
  overall delta, where deep BatchNorm biases barely move);
- running statistics: rtol 1e-9, atol 1e-10: a channel mean near zero
  (1e-3) is the difference of terms of order 1 after some hundred layers
  and two steps, whose f64 sums in another order leave a few 1e-12;
- the learning rate: both sides take the JAX schedule's values, which it
  computes in f32 (``tests/test_torch_train.py`` holds the port's own
  schedule to them, rel 1e-6); a rate 5e-8 apart moves every parameter by
  that share of its step, which moves the second step's gradient of this
  deep random model by 3e-4 relative;
- the BatchNorm affines under ``freeze_bn`` and the remat comparison:
  exact. The frozen affines are never written; remat recomputes the same
  operations on the same inputs on the CPU, and moves the running
  statistics once.
"""

import copy
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_loop import torch_one_thread  # noqa: F401  (autouse: one intra-op thread)
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
from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, load_variables
from rtda_semanticsegmentation_tpu_torch.train.optim import build_generator_tx, is_bn_affine
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


def _cfgs(which: str):
    """The JAX and port configs, f64 compute: ``deeplabv2`` is the
    ``deeplabv2_cityscapes`` preset, ``bisenet_r101`` the ``vanilla`` SGD
    mode of ``bisenet_source_small`` on a ResNet-101 context path."""
    out = []
    for cfgmod in (jconfig, tconfig):
        if which == "deeplabv2":
            cfg = cfgmod.get_preset("deeplabv2_cityscapes")
            cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float64"))
        else:
            cfg = cfgmod.get_preset("bisenet_source_small")
            cfg = cfg.replace(
                model=dataclasses.replace(cfg.model, compute_dtype="float64", context_path="resnet101"),
                augment=dataclasses.replace(cfg.augment, pipeline="no_new_aug"),
                optimizer=dataclasses.replace(cfg.optimizer, name="sgd"),
            )
        out.append(cfg)
    return out


def _flat(tree, prefix=""):
    return {prefix + k: np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f" else np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _unflat(flat):
    return flax.traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def _jax_variables(jcfg, seed):
    """f64 flat JAX train-tree variables with non-trivial BatchNorms."""
    variables = jinit_model(jbuild_model(jcfg.model), jax.random.PRNGKey(seed), (1, H, W, 3), train=True)
    flat = _flat(variables)
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


def _jax_steps(which, n_steps, seed, batch_seed):
    """The JAX package's variables and ``n_steps`` of its train step on one
    repeated batch: (flat variables, numpy batch, [(metrics, flat params,
    flat batch_stats) after each step])."""
    jcfg, _ = _cfgs(which)
    flat = _jax_variables(jcfg, seed)
    freeze_bn = jcfg.model.name == "deeplabv2"
    tx = jbuild_tx(jcfg.optimizer, MAX_ITER, freeze_bn=freeze_bn, decay_exempt=() if freeze_bn else EXEMPT)
    g = ModelState.create(jbuild_model(jcfg.model).apply, _f64(_unflat(flat)), tx)
    step = jax.jit(jmake_train_step(jcfg, jpoly(jcfg.optimizer.learning_rate, MAX_ITER)))
    images, labels, _ = _batch(batch_seed)
    state = JTrainState.create(g)
    after = []
    for _ in range(n_steps):
        state, metrics = step(state, {"image": jnp.asarray(images), "label": jnp.asarray(labels)},
                              jax.random.PRNGKey(0))
        after.append(({k: float(v) for k, v in metrics.items()}, _flat(state.generator.params, "params/"),
                      _flat(state.generator.batch_stats, "batch_stats/")))
    return flat, (images, labels), after


@pytest.fixture(scope="module")
def deeplab_run():
    jax.config.update("jax_enable_x64", True)
    try:
        return _jax_steps("deeplabv2", 2, seed=3, batch_seed=4)
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def bisenet_r101_run():
    jax.config.update("jax_enable_x64", True)
    try:
        return _jax_steps("bisenet_r101", 1, seed=5, batch_seed=6)
    finally:
        jax.config.update("jax_enable_x64", False)


def _port_state(which, flat, remat=False):
    _, tcfg = _cfgs(which)
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, remat=remat))
    model = build_model(tcfg.model, device="cpu", train=True).double()
    load_variables(model, from_jax_variables(flat))
    freeze_bn = tcfg.model.name == "deeplabv2"
    # the JAX schedule's own values (module docstring)
    jsched = jpoly(tcfg.optimizer.learning_rate, MAX_ITER)
    sched = lambda t: float(jsched(t))  # noqa: E731
    opt = build_generator_tx(tcfg.optimizer, model, freeze_bn=freeze_bn, decay_exempt=() if freeze_bn else EXEMPT)
    return TrainState(model, opt, sched), make_train_step(tcfg, sched)


def _port_flat(model):
    return {k: np.asarray(v, np.float64) for k, v in to_jax_variables(model.state_dict()).items()}


def _assert_step_matches(what, tm, jm, ours, flat, jparams, jstats):
    assert tm.keys() == jm.keys()
    for k, v in jm.items():
        assert tm[k] == pytest.approx(v, rel=1e-6 if k == "lr" else 1e-9, abs=1e-300), f"{what}: {k}"
    before = {k: v for k, v in flat.items() if k.startswith("params/")}
    _delta_parity(_unflat(before), _unflat({k: ours[k] for k in before}), _unflat(jparams), f"{what}:",
                  rel_tol=1e-6)
    assert {k for k in ours if k.startswith("batch_stats/")} == jstats.keys()
    for k, v in jstats.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-9, atol=1e-10, err_msg=f"{what}: {k}")


def test_deeplabv2_two_sgd_steps_match_jax(deeplab_run):
    """Two ``deeplabv2_cityscapes`` steps on one batch: after each, the
    metrics, every parameter and every running statistic match JAX's; the
    BatchNorm affines are the initial ones, bit for bit, while every
    running statistic has moved; the optimizer holds no BatchNorm affine."""
    flat, (images, labels), after = deeplab_run
    state, step = _port_state("deeplabv2", flat)
    held = {id(p) for group in state.optimizer.param_groups for p in group["params"]}
    affines = {n: p for n, p in state.model.named_parameters() if is_bn_affine(n)}
    assert len(affines) == 2 * 104 and not held & {id(p) for p in affines.values()}
    assert len(held) == sum(1 for _ in state.model.parameters()) - len(affines)
    initial = {n: p.detach().clone() for n, p in affines.items()}
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    for i, (jm, jparams, jstats) in enumerate(after):
        state, metrics = step(state, batch, torch.Generator())
        _assert_step_matches(f"step {i + 1}", {k: float(v) for k, v in metrics.items()}, jm,
                             _port_flat(state.model), flat, jparams, jstats)
    assert state.step == 2
    assert after[1][0]["grad_norm"] != after[0][0]["grad_norm"]
    for n, p in affines.items():
        assert torch.equal(p.detach(), initial[n]), n
    ours = _port_flat(state.model)
    assert all(not np.array_equal(ours[k], v) for k, v in flat.items() if k.startswith("batch_stats/"))


def test_bisenet_r101_vanilla_step_matches_jax(bisenet_r101_run):
    flat, (images, labels), after = bisenet_r101_run
    state, step = _port_state("bisenet_r101", flat)
    state, metrics = step(state, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)},
                          torch.Generator())
    jm, jparams, jstats = after[0]
    _assert_step_matches("BiSeNet-R101", {k: float(v) for k, v in metrics.items()}, jm,
                         _port_flat(state.model), flat, jparams, jstats)


def test_remat_gives_the_same_step_and_moves_the_running_statistics_once(deeplab_run):
    """A DeepLabV2 step with ``train.remat`` from the same state as one
    without: the same metrics, parameters and running statistics, bit for
    bit. A recompute that updated the statistics again would move them
    twice."""
    flat, (images, labels), _ = deeplab_run
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    results = []
    for remat in (False, True):
        state, step = _port_state("deeplabv2", flat, remat=remat)
        state, metrics = step(state, batch, torch.Generator())
        results.append(({k: float(v) for k, v in metrics.items()}, copy.deepcopy(state.model.state_dict())))
    (m_off, s_off), (m_on, s_on) = results
    assert m_on == m_off
    assert s_on.keys() == s_off.keys()
    for k, v in s_off.items():
        assert torch.equal(s_on[k], v), k
    initial = from_jax_variables(flat)
    moved = [k for k in s_off if k.endswith("running_mean")]
    assert moved and all(not torch.equal(s_off[k], initial[k]) for k in moved)
