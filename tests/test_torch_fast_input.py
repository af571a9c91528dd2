"""``ModelConfig.fast_input`` against the JAX package's phase-conv RGB
stems (``models/layers.py::conv_phase`` / ``_PhaseConv`` there).

The JAX phase conv is an exact rearrangement of the plain conv for the
TPU. The port carries the field and runs its plain stems at either value;
these tests hold those plain stems, and whole models and a train step built
with ``fast_input``, against JAX's phase form.

Tolerances, each with its reason:

- the port's stem ``Conv`` against JAX's ``conv_phase`` on
  ``tests/test_models.py``'s shapes and against ``_PhaseConv`` (phase form
  and its fallback): rtol and atol 1e-5, that test's (f32 on both sides,
  sums in another order);
- the forward of BiSeNet-R18 and DeepLabV2 with ``fast_input`` against
  JAX's (f32, 1 x 64 x 96, where both stems tile into phase groups): atol
  2e-4 / rtol 1e-3, ``tests/test_torch_r101.py``'s bar; against the port's
  model without it: the same bits (the same model);
- one f64 source-only step (CE, SGD, with the watch norms) with
  ``fast_input`` against JAX's: ``tests/test_torch_train.py``'s bars
  (metrics rel 1e-9, ``lr`` rel 1e-6, parameter deltas 1e-6, BatchNorm
  statistics rtol 1e-9 / atol 1e-12).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import EXEMPT, MAX_ITER, _batch, _cfgs, _delta_parity, _jax_step, _jax_variables, _port_flat, \
    _port_model, _unflat

from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu.models.factory import build_model as jbuild_model
from rtda_semanticsegmentation_tpu.models.factory import init_model as jinit_model
from rtda_semanticsegmentation_tpu.models.layers import _PhaseConv as JPhaseConv
from rtda_semanticsegmentation_tpu.models.layers import conv_phase as jconv_phase
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.models.convert import from_jax_variables
from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, load_variables
from rtda_semanticsegmentation_tpu_torch.models.layers import Conv, QuantConv
from rtda_semanticsegmentation_tpu_torch.models.quantize import quantized_model
from rtda_semanticsegmentation_tpu_torch.train.optim import build_generator_tx
from rtda_semanticsegmentation_tpu_torch.train.schedule import poly_lr_schedule
from rtda_semanticsegmentation_tpu_torch.train.state import TrainState
from rtda_semanticsegmentation_tpu_torch.train.steps import make_train_step

# tests/test_models.py::test_conv_phase_matches_lax_conv's cases:
# (H, W, ci, co, k, stride, pad, phase)
CASES = [
    (64, 96, 3, 16, 7, 2, 3, 4),
    (64, 96, 3, 16, 3, 2, 1, 4),
    (32, 48, 8, 8, 3, 1, 1, 2),
    (32, 48, 4, 8, 1, 1, 0, 2),
    (32, 48, 8, 16, 3, 2, 1, 2),
    (32, 48, 8, 16, 1, 2, 0, 2),
]
SHAPE = (1, 64, 96)
MODELS = {"bisenet": dict(), "deeplabv2": dict(name="deeplabv2")}


def _stem(x: np.ndarray, wts: np.ndarray, stride: int, pad: int) -> np.ndarray:
    """The port's stem conv (a plain bias-free ``Conv``) on NHWC ``x`` and
    HWIO ``wts``, NHWC out."""
    conv = Conv(wts.shape[2], wts.shape[3], wts.shape[0], stride, pad, bias=False)
    conv.weight.data.copy_(torch.from_numpy(wts).permute(3, 2, 0, 1))
    with torch.no_grad():
        return conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("case", CASES)
def test_conv_phase_matches_jax(case):
    """JAX's ``conv_phase`` equals the port's plain conv."""
    h, w, ci, co, k, s, p, f = case
    rng = np.random.RandomState(0)
    x = rng.randn(2, h, w, ci).astype(np.float32)
    wts = (rng.randn(k, k, ci, co) * 0.2).astype(np.float32)
    want = np.asarray(jconv_phase(jnp.asarray(x), jnp.asarray(wts), s, p, f))
    got = _stem(x, wts, s, p)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_phase_conv_falls_back_where_the_shape_does_not_tile():
    """JAX's ``_PhaseConv`` (DeepLabV2's stem: 7x7, stride 2, 64 channels)
    runs the phase form at 64 x 96 and falls back to the plain conv at
    65 x 129 (an output of 33 rows does not tile into 4 x 4 phase groups);
    the port's stem conv equals it at both."""
    layer = JPhaseConv(64, (7, 7), (2, 2), ((3, 3), (3, 3)), phase=4, dtype=jnp.float32)
    rng = np.random.RandomState(1)
    wts = (rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    for h, w in ((64, 96), (65, 129)):
        x = rng.randn(1, h, w, 3).astype(np.float32)
        want = np.asarray(layer.apply({"params": {"kernel": jnp.asarray(wts)}}, jnp.asarray(x)))
        np.testing.assert_allclose(_stem(x, wts, 2, 3), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=list(MODELS))
def jax_fast(request):
    """JAX's model with ``fast_input`` (f32), its seeded init with perturbed
    BatchNorms, and its eval logits at 1 x 64 x 96."""
    fields = MODELS[request.param]
    jcfg = jconfig.ModelConfig(compute_dtype="float32", fast_input=True, **fields)
    jmodel = jbuild_model(jcfg)
    variables = jinit_model(jmodel, jax.random.PRNGKey(0), (1, *SHAPE[1:], 3), train=False)
    flat = {k: np.array(v) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()}
    rng = np.random.RandomState(0)
    for k, v in flat.items():
        if k.endswith("/bn/scale"):
            flat[k] = rng.uniform(0.4, 0.9, v.shape).astype(np.float32)
        elif k.endswith("/bn/var"):
            flat[k] = rng.uniform(0.8, 1.6, v.shape).astype(np.float32)
        elif k.endswith("/bn/bias") or k.endswith("/bn/mean"):
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    x = np.random.RandomState(1).randn(*SHAPE, 3).astype(np.float32)
    unflat = flax.traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    logits = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, False))(unflat, x))
    return dict(fields=fields, flat=flat, x=x, logits=logits)


def _port(fields, fast_input, variables, dtype="float32"):
    cfg = tconfig.ModelConfig(compute_dtype=dtype, fast_input=fast_input, **fields)
    model = build_model(cfg, device="cpu")
    if dtype == "float64":
        model = model.double()
    load_variables(model, variables)
    return model


def test_fast_input_forward_matches_jax(jax_fast):
    model = _port(jax_fast["fields"], True, from_jax_variables(jax_fast["flat"]))
    with torch.no_grad():
        got = model(torch.from_numpy(jax_fast["x"]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, jax_fast["logits"], atol=2e-4, rtol=1e-3)


def test_fast_input_forward_matches_the_plain_stems(jax_fast):
    """``fast_input`` builds the same model: the same modules and
    parameters, and in f64 the same logits, bit for bit."""
    variables = from_jax_variables(jax_fast["flat"])
    fast = _port(jax_fast["fields"], True, variables, "float64")
    plain = _port(jax_fast["fields"], False, variables, "float64")
    assert [(n, type(m)) for n, m in fast.named_modules()] == [(n, type(m)) for n, m in plain.named_modules()]
    assert {k: v.shape for k, v in fast.state_dict().items()} == {k: v.shape for k, v in plain.state_dict().items()}
    x = torch.from_numpy(jax_fast["x"]).double().permute(0, 3, 1, 2)
    with torch.no_grad():
        assert torch.equal(fast(x), plain(x))


def test_fast_input_stems_stay_float_under_int8():
    """The stems read 3 channels, below ``quant_min_ch``: under int8 with
    ``fast_input`` they stay float convs and never become ``QuantConv``s."""
    model = quantized_model(tconfig.ModelConfig(fast_input=True), frozen=True, device="cpu")
    for stem in (model.spatial_path.convblock1.conv, model.context_path.resnet.stem.conv):
        assert type(stem) is Conv and not isinstance(stem, QuantConv)
    assert any(isinstance(m, QuantConv) for m in model.modules())


@pytest.fixture
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def test_fast_input_train_step_equals_plain(_x64):
    """One f64 source-only step (CE, SGD, the watch norms) with
    ``fast_input``: JAX's, through its phase-conv stems, equals the port's,
    whose stems are plain convs."""
    jcfg, tcfg = _cfgs("vanilla")
    jcfg, tcfg = (c.replace(model=dataclasses.replace(c.model, fast_input=True)) for c in (jcfg, tcfg))
    flat = _jax_variables(3)
    images, labels, _ = _batch(5)
    jgen, jm = _jax_step(jcfg, flat, {"image": jnp.asarray(images), "label": jnp.asarray(labels)})

    model = _port_model(tcfg, flat)
    sched = poly_lr_schedule(tcfg.optimizer.learning_rate, MAX_ITER)
    state = TrainState(model, build_generator_tx(tcfg.optimizer, model, decay_exempt=EXEMPT), sched)
    state, metrics = make_train_step(tcfg, sched)(state, {"image": torch.from_numpy(images),
                                                          "label": torch.from_numpy(labels)}, torch.Generator())
    tm = {k: float(v) for k, v in metrics.items()}
    assert tm.keys() == jm.keys()
    for k, v in jm.items():
        assert tm[k] == pytest.approx(v, rel=1e-6 if k == "lr" else 1e-9, abs=1e-300), k
    ours = _port_flat(model)
    before = {k: v for k, v in flat.items() if k.startswith("params/")}
    _delta_parity(_unflat(before), _unflat({k: ours[k] for k in before}),
                  _unflat({f"params/{k}": np.asarray(v) for k, v in
                           flax.traverse_util.flatten_dict(jgen.params, sep="/").items()}),
                  "fast_input:", rel_tol=1e-6)
    for k, v in flax.traverse_util.flatten_dict(jgen.batch_stats, sep="/").items():
        np.testing.assert_allclose(ours[f"batch_stats/{k}"], np.asarray(v), rtol=1e-9, atol=1e-12, err_msg=k)
