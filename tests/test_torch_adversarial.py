"""The port's adversarial slice against the JAX package: the FC-Discriminator
(plain and with its first conv on the K5 kernels' plain versions), its
weight bridge, ``bce_with_logits``, ``_block_mean``, the adversarial
configs and one adversarial ``make_train_step`` update in f64.

Weights: the JAX package's seeded G train tree with numpy-randomized
BatchNorms (``test_torch_train._jax_variables``) and its seeded D init,
bridged into the port. Batches: ``test_train_parity._batch`` (2 x 64 x 96
uint8 source and target frames, labels with 10% ignore), ``no_new_aug``.
The JAX Pallas kernels run in interpret mode (``FORCE_PALLAS_INTERPRET``).

Tolerances, each with its reason:

- D forward with the plain first conv: f64 rtol 1e-9 (sums in another
  order), f32 rtol 1e-5 plus atol 1e-5 * max |ref| (f32 rounding);
- D forward with the fused first conv: max |diff| <= 1e-5 * max |ref|, the
  K5 tolerance of ``tests/test_torch_conv4x4.py`` (both sides round the
  operands to bf16; only the order of the f32 sums differs);
- the D loss: rel 1e-6; its gradients, fused conv1, f32:
  max |diff| <= 1e-3 * max |ref| per tensor. The backward rounds the
  cotangent of conv1 to bf16 on both sides, and a cotangent whose f32
  value the two frameworks compute a few ulps apart can round to the
  neighbouring bf16 value (2**-8 relative) when it sits on a boundary
  (measured 3.7e-4 on conv1's kernel); the classifier's bias gradient is a
  sum of 24 terms that cancel to 1e-2 of their size (measured 1.6e-4).
  The D with a plain f32 conv1 misses these gradients by 5e-3 to 0.27;
- the weight bridge: exact;
- one step in f64 (plain first conv on both sides: f64 cannot pass through
  the fused conv's bf16 rounding): rel 1e-9 on ``loss_d``, ``loss_adv_g``,
  ``loss_ce``, ``grad_norm`` and ``grad_norm_d``; rel 1e-6 on
  ``loss_lovasz`` and the losses that contain it (the binned Lovász loss is
  f32 by design and its error sums add in another order), on ``lr`` and
  ``lr_d`` (the JAX schedules compute in f32);
  ``test_train_parity._delta_parity`` at 1e-6 on the G and D parameters;
  BatchNorm statistics rtol 1e-9, atol 1e-12.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import EXEMPT, MAX_ITER, H, W, _jax_variables, _port_flat, _port_model, _unflat  # noqa: I001
from test_train_parity import _batch, _delta_parity, _f64

from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu.models.discriminator import FCDiscriminator as JFCDiscriminator
from rtda_semanticsegmentation_tpu.models.factory import build_discriminator as jbuild_discriminator
from rtda_semanticsegmentation_tpu.models.factory import build_model as jbuild_model
from rtda_semanticsegmentation_tpu.ops import losses as jlosses
from rtda_semanticsegmentation_tpu.train import steps as jsteps
from rtda_semanticsegmentation_tpu.train.optim import build_discriminator_tx as jbuild_dtx
from rtda_semanticsegmentation_tpu.train.optim import build_generator_tx as jbuild_tx
from rtda_semanticsegmentation_tpu.train.schedule import poly_lr_schedule as jpoly
from rtda_semanticsegmentation_tpu.train.state import ModelState, TrainState as JTrainState
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from rtda_semanticsegmentation_tpu_torch.models.factory import (
    build_discriminator,
    init_discriminator,
    load_variables,
)
from rtda_semanticsegmentation_tpu_torch.ops.losses import bce_with_logits
from rtda_semanticsegmentation_tpu_torch.train import steps as tsteps
from rtda_semanticsegmentation_tpu_torch.train.optim import build_discriminator_tx, build_generator_tx
from rtda_semanticsegmentation_tpu_torch.train.schedule import poly_lr_schedule
from rtda_semanticsegmentation_tpu_torch.train.state import TrainState

C = 19
D_PARAMS = 2_781_121


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_d_flat(seed=1):
    """f32 flat JAX discriminator variables (``params/<layer>/kernel|bias``)."""
    model = JFCDiscriminator(num_classes=C, ndf=64, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, C)))
    return {k: np.array(v) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()}


def _port_d(flat, dtype="float32", fused=False):
    d = build_discriminator(tconfig.ModelConfig(compute_dtype=dtype), device="cpu", fused_conv1=fused)
    if dtype == "float64":
        d = d.double()
    load_variables(d, from_jax_variables(flat))
    return d


def _softmax_maps(seed, n=2, dtype=np.float32):
    """(n, H, W, C) softmax probabilities of 3 * randn logits."""
    logits = np.random.RandomState(seed).randn(n, H, W, C) * 3.0
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(dtype)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _max_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_discriminator_forward_matches_jax(dtype, request):
    if dtype == "float64":
        request.getfixturevalue("x64")
    flat = _jax_d_flat()
    x = _softmax_maps(4, dtype=np.float64 if dtype == "float64" else np.float32)
    jdt = getattr(jnp, dtype)
    variables = _unflat({k: v.astype(x.dtype) for k, v in flat.items()})
    ref = np.asarray(JFCDiscriminator(num_classes=C, dtype=jdt).apply(variables, jnp.asarray(x)))
    assert ref.shape == (2, H // 32, W // 32, 1) and ref.dtype == x.dtype
    with torch.no_grad():
        got = _nhwc(_port_d(flat, dtype)(_nchw(x)))
    assert got.dtype == x.dtype
    if dtype == "float64":
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_fused_discriminator_forward_matches_jax(monkeypatch):
    monkeypatch.setattr(jlosses, "FORCE_PALLAS_INTERPRET", True)
    flat = _jax_d_flat()
    x = _softmax_maps(5)
    ref = JFCDiscriminator(num_classes=C, dtype=jnp.float32, fused_conv1=True).apply(_unflat(flat), jnp.asarray(x))
    with torch.no_grad():
        got = _nhwc(_port_d(flat, fused=True)(_nchw(x)))
    assert _max_rel(got, ref) <= 1e-5
    # the fused conv1 rounds its operands to bf16: not the plain f32 D
    with torch.no_grad():
        plain = _nhwc(_port_d(flat, fused=False)(_nchw(x)))
    assert _max_rel(plain, got) > 1e-6


def test_fused_discriminator_loss_and_grads_match_jax(monkeypatch):
    """The D step's half (loss_d and its gradient w.r.t. every D parameter)
    and G's half (the adversarial BCE's gradient w.r.t. D's input), f32,
    conv1 on the fused kernels (Pallas interpret / the port's plain K5)."""
    monkeypatch.setattr(jlosses, "FORCE_PALLAS_INTERPRET", True)
    flat = _jax_d_flat()
    xs, xt = _softmax_maps(6), _softmax_maps(7)
    jd = JFCDiscriminator(num_classes=C, dtype=jnp.float32, fused_conv1=True)

    def d_loss(params):
        return 0.5 * (jlosses.bce_with_logits(jd.apply({"params": params}, xs), 1.0)
                      + jlosses.bce_with_logits(jd.apply({"params": params}, xt), 0.0))

    def adv_loss(x):
        return jlosses.bce_with_logits(jd.apply(_unflat(flat), x), 1.0)

    ref_loss, ref_grads = jax.value_and_grad(d_loss)(_unflat(flat)["params"])
    ref_adv, ref_gx = jax.value_and_grad(adv_loss)(jnp.asarray(xt))

    d = _port_d(flat, fused=True)
    loss = 0.5 * (bce_with_logits(d(_nchw(xs)), 1.0) + bce_with_logits(d(_nchw(xt)), 0.0))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-6)
    grads = to_jax_variables({n: p.grad for n, p in d.named_parameters()})
    ref_flat = {f"params/{k}": v for k, v in flax.traverse_util.flatten_dict(ref_grads, sep="/").items()}
    assert grads.keys() == ref_flat.keys()
    for k, v in ref_flat.items():
        assert _max_rel(grads[k], v) <= 1e-3, k

    d.requires_grad_(False)
    xt_t = _nchw(xt).requires_grad_(True)
    adv = bce_with_logits(d(xt_t), 1.0)
    adv.backward()
    assert adv.item() == pytest.approx(float(ref_adv), rel=1e-6)
    assert _max_rel(_nhwc(xt_t.grad), ref_gx) <= 1e-3


def test_discriminator_weights_round_trip_exactly():
    flat = _jax_d_flat(3)
    assert len(flat) == 10 and sum(v.size for v in flat.values()) == D_PARAMS
    d = _port_d(flat, fused=True)
    assert sum(p.numel() for p in d.parameters()) == D_PARAMS
    back = to_jax_variables(d.state_dict())
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_discriminator_init_and_optimizer():
    """N(0, 0.02) kernels and zero biases from a CPU generator (the same
    draws with or without the fused conv1); the D optimizer's settings."""
    cfg = tconfig.ModelConfig(compute_dtype="float32")
    a = init_discriminator(build_discriminator(cfg, device="cpu"), torch.Generator().manual_seed(0))
    b = init_discriminator(build_discriminator(cfg, device="cpu", fused_conv1=True), torch.Generator().manual_seed(0))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    kernels = torch.cat([v.flatten() for k, v in a.items() if k.endswith("weight")])
    assert kernels.std().item() == pytest.approx(0.02, rel=0.01)
    assert all(not v.any() for k, v in a.items() if k.endswith("bias"))
    d = build_discriminator(cfg, device="cpu")
    adam = build_discriminator_tx(tconfig.AdversarialConfig(), d)
    group = adam.param_groups[0]
    assert isinstance(adam, torch.optim.Adam)
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (2.5e-5, (0.9, 0.99), 1e-8, 0.0)
    sgd = build_discriminator_tx(tconfig.AdversarialConfig(disc_optimizer="sgd", disc_weight_decay=1e-4), d)
    assert isinstance(sgd, torch.optim.SGD)
    assert (sgd.param_groups[0]["momentum"], sgd.param_groups[0]["weight_decay"]) == (0.9, 1e-4)
    with pytest.raises(ValueError, match="unknown disc optimizer"):
        build_discriminator_tx(tconfig.AdversarialConfig(disc_optimizer="rmsprop"), d)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bce_with_logits_matches_jax(dtype, request):
    """Loss and gradient: rtol 1e-6 in f32, 1e-12 in f64. No logit is
    exactly 0: there ``jnp.abs``'s derivative is 1 and the JAX gradient
    ``sigmoid(0) - z - 0.5`` is off by 0.5, where the port's is exact."""
    if dtype == "float64":
        request.getfixturevalue("x64")
    rtol = 1e-6 if dtype == "float32" else 1e-12
    logits = np.random.RandomState(8).randn(2, 1, 3, 4).astype(dtype) * 4.0
    for target in (1.0, 0.0):
        ref, ref_g = jax.value_and_grad(lambda x: jlosses.bce_with_logits(x, target))(jnp.asarray(logits))
        x = torch.from_numpy(logits.copy()).requires_grad_(True)
        loss = bce_with_logits(x, target)
        loss.backward()
        assert loss.dtype == x.dtype
        assert loss.item() == pytest.approx(float(ref), rel=rtol)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), rtol=rtol, atol=1e-12)
    # a bf16 input computes in f32
    assert bce_with_logits(torch.zeros(3, dtype=torch.bfloat16), 1.0).dtype == torch.float32


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_block_mean_matches_jax(factor, x64):
    x = np.random.RandomState(9).randn(2, H, W, C)
    ref = np.asarray(jsteps._block_mean(jnp.asarray(x), factor))
    got = _nhwc(tsteps._block_mean(_nchw(x), factor))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)


def test_adversarial_presets_match_jax():
    from test_torch_bisenet import _assert_fields_match

    for preset in ("bisenet_adversarial", "bisenet_adversarial_lovasz"):
        port, ref = tconfig.get_preset(preset), jconfig.get_preset(preset)
        _assert_fields_match(port, ref)
        assert (port.train_mode, port.train_size) == (ref.train_mode, ref.train_size)
    _assert_fields_match(tconfig.AdversarialConfig(), jconfig.AdversarialConfig())
    assert tconfig.ModelConfig().disc_ndf == jconfig.ModelConfig().disc_ndf == 64


def _cfgs(mode: str, dtype: str = "float64", **adv):
    """The JAX and port configs of one adversarial mode: ``adversarial``
    with SGD for G and D (D with L2 decay) and the watch metrics on,
    ``adversarial_lovasz`` with Adam for both and the binned Lovász loss."""
    lovasz = mode == "adversarial_lovasz"
    out = []
    for cfgmod in (jconfig, tconfig):
        cfg = cfgmod.get_preset("bisenet_adversarial_lovasz" if lovasz else "bisenet_adversarial")
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, compute_dtype=dtype),
            augment=dataclasses.replace(cfg.augment, pipeline="no_new_aug"),
            loss=dataclasses.replace(cfg.loss, lovasz_impl="binned"),
            optimizer=dataclasses.replace(cfg.optimizer, name="adam" if lovasz else "sgd"),
            adversarial=dataclasses.replace(
                cfg.adversarial, disc_optimizer="adam" if lovasz else "sgd",
                disc_weight_decay=0.0 if lovasz else 1e-4, **adv),
            obs=dataclasses.replace(cfg.obs, watch_freq_steps=0 if lovasz else 10),
        )
        out.append(cfg)
    return out


def _jax_state(jcfg, gflat, dflat):
    cast = _f64 if jax.config.jax_enable_x64 else (lambda tree: tree)
    g = ModelState.create(jbuild_model(jcfg.model).apply, cast(_unflat(gflat)),
                          jbuild_tx(jcfg.optimizer, MAX_ITER, decay_exempt=EXEMPT))
    d = ModelState.create(jbuild_discriminator(jcfg.model).apply, cast(_unflat(dflat)),
                          jbuild_dtx(jcfg.adversarial, MAX_ITER))
    return JTrainState.create(g, d)


def _jax_step(jcfg):
    return jsteps.make_train_step(jcfg, jpoly(jcfg.optimizer.learning_rate, MAX_ITER),
                                  jpoly(jcfg.adversarial.disc_learning_rate, MAX_ITER))


def _port_state(tcfg, gflat, dflat):
    model = _port_model(tcfg, gflat)
    disc = _port_d(dflat, tcfg.model.compute_dtype)
    sched = poly_lr_schedule(tcfg.optimizer.learning_rate, MAX_ITER)
    d_sched = poly_lr_schedule(tcfg.adversarial.disc_learning_rate, MAX_ITER)
    state = TrainState(model, build_generator_tx(tcfg.optimizer, model, decay_exempt=EXEMPT), sched,
                       discriminator=disc, d_optimizer=build_discriminator_tx(tcfg.adversarial, disc),
                       d_schedule=d_sched)
    return state, tsteps.make_train_step(tcfg, sched, d_sched)


def _flat_params(tree, prefix="params"):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.mark.parametrize("mode", ["adversarial", "adversarial_lovasz"])
def test_adversarial_step_matches_jax(mode, x64):
    """One update, D first then G through the updated D, f64, both with the
    plain first conv; in mode ``adversarial`` with the ``watch/g/...`` and
    ``watch/d/...`` norms (rel 1e-9)."""
    jcfg, tcfg = _cfgs(mode)
    gflat = _jax_variables(3)
    dflat = {k: v.astype(np.float64) for k, v in _jax_d_flat(2).items()}
    images, labels, target = _batch(4)
    jstate, jm = jax.jit(_jax_step(jcfg))(
        _jax_state(jcfg, gflat, dflat),
        {"image": jnp.asarray(images), "label": jnp.asarray(labels), "target_image": jnp.asarray(target)},
        jax.random.PRNGKey(0))
    jm = {k: float(v) for k, v in jm.items()}

    state, step = _port_state(tcfg, gflat, dflat)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels),
             "target_image": torch.from_numpy(target)}
    state, metrics = step(state, batch, torch.Generator())
    assert state.step == 1
    tm = {k: float(v) for k, v in metrics.items()}

    assert tm.keys() == jm.keys()
    assert ("loss_lovasz" in tm) == (mode == "adversarial_lovasz")
    watched = {k.split("/")[1] for k in tm if k.startswith("watch/")}
    assert watched == (set() if mode == "adversarial_lovasz" else {"g", "d"})
    loose = {"lr", "lr_d", "loss", "loss_lovasz"} | ({"loss_seg"} if mode == "adversarial_lovasz" else set())
    for k, v in jm.items():
        assert tm[k] == pytest.approx(v, rel=1e-6 if k in loose else 1e-9, abs=1e-300), k
    assert tm["loss_d"] == pytest.approx(np.log(2.0), abs=0.05)

    ours = _port_flat(state.model)
    before = {k: v for k, v in gflat.items() if k.startswith("params/")}
    _delta_parity(_unflat(before), _unflat({k: ours[k] for k in before}),
                  _unflat(_flat_params(jstate.generator.params)), f"{mode} G:", rel_tol=1e-6)
    ours_d = to_jax_variables(state.discriminator.state_dict())
    _delta_parity(_unflat(dflat), _unflat(ours_d), _unflat(_flat_params(jstate.discriminator.params)),
                  f"{mode} D:", rel_tol=1e-6)
    for k, v in flax.traverse_util.flatten_dict(jstate.generator.batch_stats, sep="/").items():
        np.testing.assert_allclose(ours[f"batch_stats/{k}"], np.asarray(v), rtol=1e-9, atol=1e-12, err_msg=k)


def test_adversarial_config_errors_raise_in_both_packages():
    """The JAX package's three ValueErrors, with its messages: a
    ``disc_downsample`` below 1, a pooled side below 32, and a train
    resolution the factor does not divide."""
    jcfg, tcfg = _cfgs("adversarial", "float32", disc_downsample=0)
    with pytest.raises(ValueError, match="disc_downsample must be >= 1, got 0"):
        jsteps.make_train_step(jcfg, jpoly(1e-4, MAX_ITER), jpoly(1e-4, MAX_ITER))
    with pytest.raises(ValueError, match="disc_downsample must be >= 1, got 0"):
        tsteps.make_train_step(tcfg, poly_lr_schedule(1e-4, MAX_ITER), poly_lr_schedule(1e-4, MAX_ITER))

    for block_mean, x in ((jsteps._block_mean, jnp.zeros((1, 64, 96, C))),
                          (tsteps._block_mean, torch.zeros(1, C, 64, 96))):
        with pytest.raises(ValueError, match="disc_downsample=5 must divide the train resolution; got a 64x96 map"):
            block_mean(x, 5)

    # 32 x 48 frames pooled by 2: a 16 x 24 discriminator input
    jcfg, tcfg = _cfgs("adversarial", "float32", disc_downsample=2)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 32, 48, 3), np.uint8)
    labels = rng.randint(0, C, (2, 32, 48)).astype(np.int32)
    gflat = {k: v.astype(np.float32) for k, v in _jax_variables(1).items()}
    dflat = _jax_d_flat()
    msg = "discriminator input 16x24 .* below the 32-pixel minimum"
    with pytest.raises(ValueError, match=msg):
        jax.jit(_jax_step(jcfg)).lower(
            _jax_state(jcfg, gflat, dflat),
            {"image": jnp.asarray(images), "label": jnp.asarray(labels), "target_image": jnp.asarray(images)},
            jax.random.PRNGKey(0))
    state, step = _port_state(tcfg, gflat, dflat)
    state.model.float()
    with pytest.raises(ValueError, match=msg):
        step(state, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels),
                     "target_image": torch.from_numpy(images)}, torch.Generator())
