"""The port's BiSeNet-R18 (bridge, eval forward, calibration, int8 path)
against the JAX package on shared numpy-seeded weights and inputs.

Weights: the JAX package's seeded init with numpy-perturbed BatchNorm
affines and statistics, bridged into the port by
``models/convert.py::from_jax_variables``. Inputs: numpy uint8 frames
through each package's ``normalize_u8``, 2 x 64 x 128.

Tolerances, each with its reason:

- bridge round trips: exact (transposes and renames only);
- f32 eval logits: atol 2e-4 / rtol 1e-3 (the ``tests/test_convert.py:339``
  bar): XLA and PyTorch sum the convs in different orders;
- calibration statistics of one quantized conv on identical inputs:
  ``in_absmax`` exact (a max), ``in_mean`` <= 1e-5 relative (a mean reduced
  in another order); over the whole model the conv inputs themselves differ
  at f32 rounding level, so there the statistics agree to 1e-4 relative;
- int8 logits (f32 compute) on the JAX package's own frozen constants:
  argmax agreement >= 0.99 and max |diff| <= 1e-2 * max |logit|. The port
  fuses the BatchNorm into the kernel's epilogue (``acc * a + b``) where JAX
  dequantizes, then applies BN; the rounding differs at f32 level, which can
  move a downstream requantized code by one.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu.models import quantize as jquant
from rtda_semanticsegmentation_tpu.models.factory import build_model as jbuild_model
from rtda_semanticsegmentation_tpu.models.factory import init_model as jinit_model
from rtda_semanticsegmentation_tpu.models.layers import QuantConv as JQuantConv
from rtda_semanticsegmentation_tpu.ops.augment import normalize_u8 as jnormalize_u8
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.kernels import int8_conv as k3
from rtda_semanticsegmentation_tpu_torch.models import quantize as tquant
from rtda_semanticsegmentation_tpu_torch.models.convert import (
    from_jax_variables,
    load_npz_into_state,
    to_jax_variables,
)
from rtda_semanticsegmentation_tpu_torch.models.factory import (
    build_model,
    init_model,
    load_variables,
)
from rtda_semanticsegmentation_tpu_torch.models.layers import QuantConv
from rtda_semanticsegmentation_tpu_torch.ops.augment import normalize_u8

B, H, W = 2, 64, 128
JCFG = jconfig.ModelConfig(compute_dtype="float32")
TCFG = tconfig.ModelConfig(compute_dtype="float32")


def _flat(variables):
    return {k: np.array(v) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()}


def _unflat(flat):
    return flax.traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def _frames(seed):
    return np.random.RandomState(seed).randint(0, 256, (B, H, W, 3), np.uint8)


def _inputs(seed):
    u8 = _frames(seed)
    jx = np.array(jnormalize_u8(jnp.asarray(u8), jconfig.AugmentConfig()))
    tx = normalize_u8(torch.from_numpy(u8), tconfig.AugmentConfig())
    np.testing.assert_array_equal(tx.numpy(), jx)  # same f32 ops, same bits
    return jx


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's f32 forward, calibration, freeze and int8 forward."""
    jmodel = jbuild_model(JCFG)
    flat = _flat(jinit_model(jmodel, jax.random.PRNGKey(0), (1, H, W, 3), train=False))
    rng = np.random.RandomState(0)
    for k, v in flat.items():  # non-trivial BatchNorm folds
        if k.endswith("/bn/scale"):
            flat[k] = rng.uniform(0.4, 0.9, v.shape).astype(np.float32)
        elif k.endswith("/bn/var"):
            flat[k] = rng.uniform(0.8, 1.6, v.shape).astype(np.float32)
        elif k.endswith("/bn/bias") or k.endswith("/bn/mean"):
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    variables = _unflat(flat)
    x, calib = _inputs(1), [_inputs(2), _inputs(3)]
    logits = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, False))(variables, x))
    cal = jquant.calibrate(JCFG, variables, calib)
    frozen = jquant.freeze(JCFG, cal)
    qmodel = jquant.quantized_model(JCFG, frozen=True)
    q_logits = np.asarray(jax.jit(lambda v, x: qmodel.apply(v, x, False))(frozen, x))
    return dict(flat=flat, x=x, calib=calib, logits=logits, cal=_flat(cal),
                frozen=_flat(frozen), q_logits=q_logits)


def _port_logits(cfg, variables, x, quant=False):
    model = tquant.quantized_model(cfg, device="cpu") if quant else build_model(cfg, device="cpu")
    load_variables(model, variables)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).numpy()


def _assert_fields_match(port, ref):
    """Every field of ``port`` is ``ref``'s, by name and value, but the
    port's own SegFormer fields (``config.PORT_ONLY_FIELDS``), which
    ``ref`` lacks."""
    for f in dataclasses.fields(port):
        if f.name in tconfig.PORT_ONLY_FIELDS:
            assert not hasattr(ref, f.name), f.name
            continue
        value = getattr(port, f.name)
        if dataclasses.is_dataclass(value):
            _assert_fields_match(value, getattr(ref, f.name))
        else:
            assert value == getattr(ref, f.name), f.name


def test_config_defaults_match_jax():
    """Every field of the port's configs has the JAX package's name and
    default, and the ported presets and derived properties agree."""
    names = ("ModelConfig", "AugmentConfig", "DataConfig", "OptimizerConfig",
             "AdversarialConfig", "LossConfig", "TrainConfig", "ExperimentConfig")
    for name in names:
        _assert_fields_match(getattr(tconfig, name)(), getattr(jconfig, name)())
    for preset in ("bisenet_source_small", "bisenet_source_aug"):
        port, ref = tconfig.get_preset(preset), jconfig.get_preset(preset)
        _assert_fields_match(port, ref)
        assert (port.train_mode, port.train_size) == (ref.train_mode, ref.train_size)
    for pipeline in ("no_new_aug", "hflip_only", "all_four_combined", "all_four_plus_hflip"):
        assert (tconfig.AugmentConfig(pipeline=pipeline).flags
                == jconfig.AugmentConfig(pipeline=pipeline).flags)


def test_jax_variables_cover_the_port_model(jax_run):
    """Every port tensor has a JAX counterpart of the same shape and none
    is left over: the module trees mirror each other."""
    state = from_jax_variables(jax_run["flat"])
    own = build_model(TCFG, device="cpu").state_dict()
    assert state.keys() == own.keys()
    for k, v in own.items():
        assert state[k].shape == v.shape, k


def test_bridge_round_trips_are_exact(jax_run):
    # JAX -> port -> JAX, over every collection of the frozen int8 tree
    flat = jax_run["frozen"]
    back = to_jax_variables(from_jax_variables(flat))
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    # port -> JAX -> port, including the port-only fused epilogue constants
    state = tquant.freeze(TCFG, from_jax_variables(jax_run["cal"]))
    again = from_jax_variables(to_jax_variables(state))
    assert again.keys() == state.keys()
    for k, v in state.items():
        assert again[k].dtype == v.dtype and torch.equal(again[k], v), k


def test_f32_logits_match_jax(jax_run):
    got = _port_logits(TCFG, from_jax_variables(jax_run["flat"]), jax_run["x"])
    assert got.shape == (B, H, W, 19)
    np.testing.assert_allclose(got, jax_run["logits"], atol=2e-4, rtol=1e-3)


def test_quant_conv_calibration_stats_match_jax():
    rng = np.random.RandomState(8)
    xs = [np.maximum(rng.randn(2, 6, 10, 128), 0).astype(np.float32) * rng.rand(128).astype(np.float32)
          for _ in range(2)]
    jconv = JQuantConv(16, (3, 3), (1, 1), ((1, 1), (1, 1)), mode="calib", dtype=jnp.float32)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    kernel = np.array(variables["params"]["kernel"])
    for x in xs:
        _, muts = jconv.apply(variables, jnp.asarray(x), mutable=["quant_stats"])
        variables = {**variables, **muts}
    want = {k: np.asarray(v) for k, v in variables["quant_stats"].items()}

    conv = QuantConv(128, 16, 3, 1, 1, mode="calib", relu=False)
    conv.weight.data.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
    for x in xs:
        conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(conv.in_absmax.numpy(), want["in_absmax"])
    np.testing.assert_allclose(conv.in_mean.numpy(), want["in_mean"], rtol=1e-5, atol=0)
    assert float(conv.calib_batches) == float(want["calib_batches"]) == 2.0


def test_model_calibration_matches_jax(jax_run):
    cal = tquant.calibrate(TCFG, from_jax_variables(jax_run["flat"]),
                           [torch.from_numpy(x) for x in jax_run["calib"]], device="cpu")
    got = {k: v for k, v in to_jax_variables(cal).items() if k.startswith("quant_stats/")}
    want = {k: v for k, v in jax_run["cal"].items() if k.startswith("quant_stats/")}
    assert got.keys() == want.keys() and len(want) == 3 * 15
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_int8_logits_on_jax_frozen_constants(jax_run):
    variables = tquant.freeze(TCFG, from_jax_variables(jax_run["frozen"]))
    got = _port_logits(TCFG, variables, jax_run["x"], quant=True)
    want = jax_run["q_logits"]
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.99, agree
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("skip", [(), ("ffm", "layer4")])
def test_quant_policy_routes_the_same_convs_through_the_kernel(jax_run, monkeypatch, skip):
    jax_convs = sorted(k[len("quant_stats/"):-len("/in_absmax")]
                       for k in jax_run["cal"] if k.endswith("/in_absmax"))
    expected = [p for p in jax_convs if not any(s in p for s in skip)]
    cfg = dataclasses.replace(TCFG, quant_skip=skip)
    variables = tquant.freeze(cfg, tquant.calibrate(
        cfg, from_jax_variables(jax_run["flat"]), [torch.from_numpy(jax_run["calib"][0])], device="cpu"))
    got = sorted(k[len("quant_stats/"):-len("/in_absmax")]
                 for k in to_jax_variables(variables) if k.endswith("/in_absmax"))
    assert got == expected and len(jax_convs) == 15

    calls = []
    plain = k3.int8_conv

    def counting(*args, **kw):
        calls.append(kw["stride"])
        return plain(*args, **kw)

    monkeypatch.setattr(k3, "int8_conv", counting)
    _port_logits(cfg, variables, jax_run["x"][:1], quant=True)
    assert len(calls) == len(expected)


def test_pretrained_backbone_graft(jax_run, tmp_path):
    flat = jax_run["flat"]
    backbone = {k: v for k, v in flat.items() if "/context_path/resnet/" in k}
    sup = np.random.RandomState(1).randn(1, 1, 256, 19).astype(np.float32)
    backbone["params/supervision1/kernel"] = sup
    path = tmp_path / "backbone.npz"
    np.savez(path, **backbone)
    fresh = init_model(build_model(TCFG, device="cpu"), torch.Generator().manual_seed(0))
    grafted = load_npz_into_state(fresh, str(path), "bisenet")
    want = from_jax_variables(flat)
    for k, v in grafted.items():
        if k.startswith("context_path.resnet."):
            assert torch.equal(v, want[k]), k
        else:
            assert torch.equal(v, fresh[k]), k  # keeps its seeded init
    # a train model has the aux heads, and the graft loads them
    train = init_model(build_model(TCFG, device="cpu", train=True), torch.Generator().manual_seed(0))
    assert all(torch.equal(train[k], v) for k, v in fresh.items())  # one seed, the same weights
    grafted = load_npz_into_state(train, str(path), "bisenet")
    assert torch.equal(grafted["supervision1.weight"], torch.from_numpy(sup.transpose(3, 2, 0, 1)))
    assert torch.equal(grafted["supervision2.weight"], train["supervision2.weight"])

    np.savez(tmp_path / "unknown.npz", **{"params/nope/conv/kernel": np.zeros((1, 1, 1, 1), np.float32)})
    with pytest.raises(KeyError):
        load_npz_into_state(fresh, str(tmp_path / "unknown.npz"), "bisenet")
    key = "params/context_path/resnet/stem/conv/kernel"
    np.savez(tmp_path / "shape.npz", **{key: np.zeros((3, 3, 3, 64), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_npz_into_state(fresh, str(tmp_path / "shape.npz"), "bisenet")


def test_seeded_init_is_reproducible_and_device_free():
    a = init_model(build_model(TCFG, device="cpu"), torch.Generator().manual_seed(3))
    b = init_model(build_model(TCFG, device="cpu"), torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["context_path.resnet.layer3_0.conv1.conv.weight"]  # fan-out Kaiming
    assert abs(float(w.std()) - (2.0 / (256 * 9)) ** 0.5) < 0.1 * (2.0 / (256 * 9)) ** 0.5
