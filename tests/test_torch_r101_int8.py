"""int8 serving of the port's ResNet-101 models, and the dilated s8 conv
(kernel K3), against the JAX package.

On the CPU the wrapper ``kernels/int8_conv.py::int8_conv`` runs the
kernel's plain version; the CUDA kernel matches that version bit for bit on
the card (``tests/test_torch_cuda.py``, and ``chip_smoke.py`` at the
models' dilated shapes).

- The plain version at dilations 1, 2 and 4 and strides 1 and 2 against
  ``ops/quant.py::int8_conv_frozen`` with ``rhs_dilation`` (XLA's s8 conv,
  exact on the CPU), and its zero-code border correction with a dilation.
- BiSeNet-R101 and DeepLabV2 calibrated, frozen and served in int8
  (``frozen=True`` and the non-frozen ``int8`` mode) at 1 x 64 x 128 on the
  CPU, against JAX's ``calibrate`` / ``freeze`` / ``quantized_model`` on the
  same weights (the JAX seeded init with numpy-perturbed BatchNorms,
  bridged) and inputs. Each JAX model is built and run once per module.

Tolerances, each with its reason:

- the s8 conv: none (integer accumulators, each f32 epilogue operation
  rounded alike);
- calibration statistics over a whole model: rtol 1e-4 (the
  ``tests/test_torch_bisenet.py`` bar: the conv inputs differ at f32
  rounding level) with an atol of 1e-5 of the conv's largest statistic, not
  R18's 1e-6 absolute: through the 100 layers of an R101 trunk the f32
  differences reach a few 1e-7 of a layer's scale, which a channel whose
  statistic is a thousandth of the others' sees as its own error;
- ``freeze``: ``wq`` exact, ``sw`` rtol 1e-6, ``c`` within 1e-6 of its
  conv's max |c| (an f32 sum reduced in another order), the
  ``tests/test_torch_quant.py`` bars;
- int8 logits (f32 compute): argmax agreement >= 0.99 and max |diff| <=
  1e-2 * max |logit|, the ``tests/test_torch_bisenet.py`` bar: the port
  folds the BatchNorm into the kernel's epilogue where JAX dequantizes, then
  applies it, and a difference at f32 rounding level can move a downstream
  requantized code by one;
- the port's ``frozen=False`` against its ``frozen=True``: exact (the same
  expressions on the same tensors).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_loop import torch_one_thread  # noqa: F401  (autouse: one intra-op thread)

from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu.models import quantize as jquant
from rtda_semanticsegmentation_tpu.models.factory import build_model as jbuild_model
from rtda_semanticsegmentation_tpu.models.factory import init_model as jinit_model
from rtda_semanticsegmentation_tpu.ops import quant as jq
from rtda_semanticsegmentation_tpu.ops.augment import normalize_u8 as jnormalize_u8
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.kernels import int8_conv as k3
from rtda_semanticsegmentation_tpu_torch.models import quantize as tquant
from rtda_semanticsegmentation_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from rtda_semanticsegmentation_tpu_torch.models.factory import load_variables
from rtda_semanticsegmentation_tpu_torch.models.layers import QuantConv, fold_kernel_operands
from rtda_semanticsegmentation_tpu_torch.ops import quant as tq

B, H, W = 1, 64, 128
# (config fields, quantized convs per forward, K3 launches per forward by dilation)
MODELS = {
    "bisenet_r101": (dict(context_path="resnet101"), 97, {1: 97}),
    "deeplabv2": (dict(name="deeplabv2"), 95, {1: 69, 2: 23, 4: 3}),
}
# (kernel, stride, pad, dilation): DeepLabV2's dilated 3x3 convs (padding =
# dilation) at both strides, the undilated 3x3 ones and the R101 models'
# 1x1/s1
DILATED = [(3, 1, 2, 2), (3, 2, 2, 2), (3, 1, 4, 4), (3, 2, 4, 4), (3, 1, 1, 1), (3, 2, 1, 1), (1, 1, 0, 1)]


def _jax_frozen(x, wq, sw, c, absmax, s, p, d):
    out = jq.int8_conv_frozen(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw), jnp.asarray(c), jnp.asarray(absmax),
        (s, s), ((p, p), (p, p)), dilation=(d, d), out_dtype=jnp.float32,
    )
    return np.asarray(out)


def _port_frozen(x, wq, sw, c, absmax, s, p, d):
    t = torch.from_numpy
    return tq.int8_conv_frozen(t(x), t(wq), t(sw), t(c), t(absmax), (s, s), ((p, p), (p, p)), (d, d),
                               out_dtype=torch.float32).numpy()


@pytest.mark.parametrize("k,s,p,d", DILATED)
def test_dilated_accumulator_matches_xla_s8_conv_exactly(k, s, p, d):
    """Unit epilogue (a = 1, b = 0, f32 out) exposes the raw s32
    accumulator; codes go in as values 0..254 on the unsigned grid
    (absmax 254)."""
    rng = np.random.RandomState(100 + 10 * d + s + k)
    codes = rng.randint(0, 255, (2, 15, 17, 32)).astype(np.float32)
    wq = rng.randint(-127, 128, (k, k, 32, 24)).astype(np.int8)
    ones, zeros, absmax = np.ones(24, np.float32), np.zeros(24, np.float32), np.full(32, 254.0, np.float32)
    want = _jax_frozen(codes, wq, ones, zeros, absmax, s, p, d)
    got = _port_frozen(codes, wq, ones, zeros, absmax, s, p, d)
    assert got.shape == want.shape == (2, k3.out_size(15, k, s, p, d), k3.out_size(17, k, s, p, d), 24)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,s,p,d", DILATED)
def test_dilated_frozen_conv_matches_jax_int8_conv_frozen_exactly(k, s, p, d):
    """Float input through the quantizer, the zero-code pad and the
    ``acc * sw + c`` epilogue."""
    rng = np.random.RandomState(200 + 10 * d + s + k)
    x = np.abs(rng.randn(2, 15, 17, 48)).astype(np.float32) * rng.rand(48).astype(np.float32)
    absmax = np.abs(x).max(axis=(0, 1, 2))
    wq = rng.randint(-127, 128, (k, k, 48, 19)).astype(np.int8)
    sw = (rng.rand(19).astype(np.float32) + 0.5) * 1e-3
    c = rng.randn(19).astype(np.float32)
    np.testing.assert_array_equal(_port_frozen(x, wq, sw, c, absmax, s, p, d),
                                  _jax_frozen(x, wq, sw, c, absmax, s, p, d))


def _s32_conv(xq, wq, stride, dilation):
    x = xq.permute(0, 3, 1, 2).double()
    w = wq.permute(3, 2, 0, 1).double()
    return torch.round(F.conv2d(x, w, stride=stride, dilation=dilation)).to(torch.int64).permute(0, 2, 3, 1)


@pytest.mark.parametrize("s,d,h,w", [(1, 2, 9, 13), (2, 2, 9, 12), (1, 4, 11, 9), (2, 4, 12, 11)])
def test_dilated_border_correction_turns_the_zero_filled_conv_into_the_zero_code_padded_one(s, d, h, w):
    """What the kernel computes (TMA fills the border with 0) plus the
    epilogue's correction, with the taps ``d`` apart, equals the
    -127-padded dilated conv exactly (3x3, padding = dilation)."""
    rng = np.random.RandomState(300 + 10 * d + s)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, h, w, 13)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (3, 3, 13, 19)).astype(np.int8))
    zero_filled = _s32_conv(F.pad(xq, (0, 0, d, d, d, d)), wq, s, d)
    padded = _s32_conv(k3.pad_zero_code(xq, d), wq, s, d)
    _, colsum = k3.kmajor_weights(wq)
    corr = k3.zero_code_border_correction(colsum, h, w, 3, 3, s, d, d)
    assert corr.shape == padded.shape[1:] and bool(corr.any())
    assert torch.equal(zero_filled + corr, padded)


def test_wrapper_refuses_a_dilation_below_one():
    t = torch.from_numpy
    xq = t(np.zeros((1, 8, 8, 16), np.int8))
    wq = t(np.zeros((3, 3, 16, 8), np.int8))
    a, b = t(np.ones(8, np.float32)), t(np.zeros(8, np.float32))
    with pytest.raises(ValueError, match="dilation"):
        k3.int8_conv(xq, wq, a, b, stride=1, padding=1, dilation=0, relu=False)


def _flat(variables):
    return {k: np.array(v) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()}


def _unflat(flat):
    return flax.traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def _inputs(seed):
    u8 = np.random.RandomState(seed).randint(0, 256, (B, H, W, 3), np.uint8)
    return np.array(jnormalize_u8(jnp.asarray(u8), jconfig.AugmentConfig()))


def _jax_run(which):
    """The JAX package's calibration (2 batches), freeze and int8 forwards,
    frozen and not, in f32 compute."""
    fields, _, _ = MODELS[which]
    jcfg = jconfig.ModelConfig(compute_dtype="float32", **fields)
    flat = _flat(jinit_model(jbuild_model(jcfg), jax.random.PRNGKey(0), (1, H, W, 3), train=False))
    rng = np.random.RandomState(0)
    for k, v in flat.items():  # non-trivial BatchNorm folds
        if k.endswith("/bn/scale"):
            flat[k] = rng.uniform(0.4, 0.9, v.shape).astype(np.float32)
        elif k.endswith("/bn/var"):
            flat[k] = rng.uniform(0.8, 1.6, v.shape).astype(np.float32)
        elif k.endswith("/bn/bias") or k.endswith("/bn/mean"):
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    x, calib = _inputs(1), [_inputs(2), _inputs(3)]
    cal = jquant.calibrate(jcfg, _unflat(flat), calib)
    frozen = jquant.freeze(jcfg, cal)
    q_frozen = jquant.quantized_model(jcfg, frozen=True)
    q_live = jquant.quantized_model(jcfg, frozen=False)
    return dict(
        cfg=tconfig.ModelConfig(compute_dtype="float32", **fields), flat=flat, x=x, calib=calib,
        cal=_flat(cal), frozen=_flat(frozen),
        logits_frozen=np.asarray(jax.jit(lambda v, x: q_frozen.apply(v, x, False))(frozen, x)),
        logits_live=np.asarray(jax.jit(lambda v, x: q_live.apply(v, x, False))(cal, x)),
    )


@pytest.fixture(scope="module")
def bisenet_r101():
    return _jax_run("bisenet_r101")


@pytest.fixture(scope="module")
def deeplabv2():
    return _jax_run("deeplabv2")


@pytest.fixture(params=list(MODELS))
def run(request):
    return request.param, request.getfixturevalue(request.param)


def _paths(flat, suffix="/in_absmax"):
    return sorted(k[len("quant_stats/"):-len(suffix)] for k in flat if k.startswith("quant_stats/")
                  and k.endswith(suffix))


def _port_logits(cfg, variables, x, frozen):
    model = tquant.quantized_model(cfg, frozen=frozen, device="cpu")
    load_variables(model, variables)
    fold_kernel_operands(model)
    with torch.no_grad():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


def test_quantized_convs_and_k3_launches_match_jax(run, monkeypatch):
    """The port quantizes the convs JAX does (by flax path, dilated ones
    included), and one int8 forward calls K3 once for each, at its
    dilation: 97 for BiSeNet-R101, 95 for DeepLabV2 (23 at d = 2, 3 at
    d = 4)."""
    which, r = run
    _, n, by_dilation = MODELS[which]
    cal = tquant.calibrate(r["cfg"], from_jax_variables(r["flat"]), [torch.from_numpy(r["calib"][0])],
                           device="cpu")
    assert _paths(to_jax_variables(cal)) == _paths(r["cal"]) and len(_paths(r["cal"])) == n
    model = tquant.quantized_model(r["cfg"], device="cpu")
    assert sum(isinstance(m, QuantConv) for m in model.modules()) == n
    calls = []
    plain = k3.int8_conv

    def counting(*args, **kw):
        calls.append(kw["dilation"])
        return plain(*args, **kw)

    monkeypatch.setattr(k3, "int8_conv", counting)
    _port_logits(r["cfg"], tquant.freeze(r["cfg"], cal), r["x"], frozen=True)
    assert {d: calls.count(d) for d in set(calls)} == by_dilation


def test_calibration_matches_jax(run):
    _, r = run
    cal = tquant.calibrate(r["cfg"], from_jax_variables(r["flat"]), [torch.from_numpy(x) for x in r["calib"]],
                           device="cpu")
    got = {k: v for k, v in to_jax_variables(cal).items() if k.startswith("quant_stats/")}
    want = {k: v for k, v in r["cal"].items() if k.startswith("quant_stats/")}
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5 * np.abs(v).max(), err_msg=k)


def test_freeze_matches_jax_quant_frozen(run):
    """The port's ``freeze`` of JAX's calibrated variables: ``wq`` / ``sw``
    / ``c`` of every quantized conv (Bottleneck convs with and without
    ReLU, downsample projections) against JAX's ``quant_frozen``."""
    _, r = run
    got = to_jax_variables(tquant.freeze(r["cfg"], from_jax_variables(r["cal"])))
    want = {k: v for k, v in r["frozen"].items() if k.startswith("quant_frozen/")}
    assert {k for k in got if k.startswith("quant_frozen/") and k.rsplit("/", 1)[1] in ("wq", "sw", "c")} \
        == want.keys()
    for k, v in want.items():
        name = k.rsplit("/", 1)[1]
        if name == "wq":
            assert got[k].dtype == np.int8
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        elif name == "sw":
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=0, err_msg=k)
        else:
            assert np.abs(got[k] - v).max() <= 1e-6 * np.abs(v).max(), k


@pytest.mark.parametrize("frozen", [True, False])
def test_int8_logits_match_jax(run, frozen):
    """``frozen=True`` on JAX's own frozen constants against JAX's frozen
    model; ``frozen=False`` on JAX's calibrated variables against JAX's
    ``int8`` mode."""
    _, r = run
    if frozen:
        got = _port_logits(r["cfg"], tquant.freeze(r["cfg"], from_jax_variables(r["frozen"])), r["x"], True)
        want = r["logits_frozen"]
    else:
        got = _port_logits(r["cfg"], from_jax_variables(r["cal"]), r["x"], False)
        want = r["logits_live"]
    assert got.shape == want.shape == (B, H, W, 19)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.99, agree
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_non_frozen_int8_gives_the_frozen_models_outputs(run):
    """The ``int8`` mode recomputes ``freeze``'s constants on each forward
    from the same weights and statistics: the same logits, bit for bit."""
    _, r = run
    cal = from_jax_variables(r["cal"])
    frozen = _port_logits(r["cfg"], tquant.freeze(r["cfg"], cal), r["x"], True)
    live = _port_logits(r["cfg"], cal, r["x"], False)
    np.testing.assert_array_equal(live, frozen)
