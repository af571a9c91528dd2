"""The port's ResNet-101 models, BiSeNet-R101 and DeepLabV2, against the JAX
package on shared numpy-seeded weights and inputs, and their serving.

Weights: the JAX package's seeded init with numpy-perturbed BatchNorm
affines and statistics, bridged into the port by
``models/convert.py::from_jax_variables``. Inputs: numpy uint8 frames
through each package's ``normalize_u8``: BiSeNet-R101 at 2 x 64 x 96,
DeepLabV2 at 1 x 65 x 129 (odd sizes, which exercise the ceil-mode stem
pool). Each JAX model is built and initialised once per module (an R101
init takes tens of seconds on a CPU).

Tolerances, each with its reason:

- bridge round trips: exact (transposes and renames only);
- f32 eval logits: atol 2e-4 / rtol 1e-3 (the ``tests/test_convert.py:339``
  bar): XLA and PyTorch sum the convs in different orders;
- f32 masks served by the port equal the argmax of JAX's logits at every
  pixel whose top-2 JAX logits lie more than 1e-3 apart (within that margin
  the f32 rounding differences may flip the argmax).

Their training and int8 serving against JAX: ``tests/test_torch_r101_train.py``
and ``tests/test_torch_r101_int8.py``.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu.models.factory import build_model as jbuild_model
from rtda_semanticsegmentation_tpu.models.factory import init_model as jinit_model
from rtda_semanticsegmentation_tpu.ops.augment import normalize_u8 as jnormalize_u8
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.cli.predict import main as predict_main
from rtda_semanticsegmentation_tpu_torch.kernels import conv3x3 as k4
from rtda_semanticsegmentation_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from rtda_semanticsegmentation_tpu_torch.models.deeplabv2 import DeepLabV2
from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, init_model, load_variables
from rtda_semanticsegmentation_tpu_torch.models.layers import ConvBN, QuantConv, fold_kernel_operands
from rtda_semanticsegmentation_tpu_torch.models.quantize import calibrate
from rtda_semanticsegmentation_tpu_torch.ops.augment import normalize_u8
from rtda_semanticsegmentation_tpu_torch.serving import make_serving_fn

# (JAX config fields, input (B, H, W))
MODELS = {
    "bisenet_r101": (dict(context_path="resnet101"), (2, 64, 96)),
    "deeplabv2": (dict(name="deeplabv2"), (1, 65, 129)),
}


def _flat(variables):
    return {k: np.array(v) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()}


def _unflat(flat):
    return flax.traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def _frames(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, (*shape, 3), np.uint8)


def _jax_run(which):
    fields, shape = MODELS[which]
    jcfg = jconfig.ModelConfig(compute_dtype="float32", **fields)
    jmodel = jbuild_model(jcfg)
    flat = _flat(jinit_model(jmodel, jax.random.PRNGKey(0), (1, *shape[1:], 3), train=False))
    rng = np.random.RandomState(0)
    for k, v in flat.items():  # non-trivial BatchNorm folds
        if k.endswith("/bn/scale"):
            flat[k] = rng.uniform(0.4, 0.9, v.shape).astype(np.float32)
        elif k.endswith("/bn/var"):
            flat[k] = rng.uniform(0.8, 1.6, v.shape).astype(np.float32)
        elif k.endswith("/bn/bias") or k.endswith("/bn/mean"):
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    frames = _frames(1, shape)
    x = np.array(jnormalize_u8(jnp.asarray(frames), jconfig.AugmentConfig()))
    logits = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, False))(_unflat(flat), x))
    cfg = tconfig.ModelConfig(compute_dtype="float32", **fields)
    return dict(cfg=cfg, flat=flat, frames=frames, x=x, logits=logits, shape=shape)


@pytest.fixture(scope="module")
def bisenet_r101():
    return _jax_run("bisenet_r101")


@pytest.fixture(scope="module")
def deeplabv2():
    return _jax_run("deeplabv2")


@pytest.fixture(params=list(MODELS))
def run(request):
    return request.getfixturevalue(request.param)


def _port_logits(cfg, variables, x):
    model = build_model(cfg, device="cpu")
    load_variables(model, variables)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).numpy()


def test_jax_variables_cover_the_port_model(run):
    """Every port tensor has a JAX counterpart of the same shape and none is
    left over: the module trees mirror each other."""
    state = from_jax_variables(run["flat"])
    own = build_model(run["cfg"], device="cpu").state_dict()
    assert state.keys() == own.keys()
    for k, v in own.items():
        assert state[k].shape == v.shape, k


def test_bridge_round_trips_are_exact(run):
    flat = run["flat"]
    back = to_jax_variables(from_jax_variables(flat))
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    state = init_model(build_model(run["cfg"], device="cpu"), torch.Generator().manual_seed(2))
    again = from_jax_variables(to_jax_variables(state))
    assert again.keys() == state.keys()
    for k, v in state.items():
        assert again[k].dtype == v.dtype and torch.equal(again[k], v), k


def test_f32_logits_match_jax(run):
    got = _port_logits(run["cfg"], from_jax_variables(run["flat"]), run["x"])
    assert got.shape == (*run["shape"], 19)
    np.testing.assert_allclose(got, run["logits"], atol=2e-4, rtol=1e-3)


def test_f32_serving_matches_jax_outside_near_ties(run):
    serve = make_serving_fn(run["cfg"], tconfig.AugmentConfig(), from_jax_variables(run["flat"]),
                            "f32", device="cpu")
    got = serve(torch.from_numpy(run["frames"]))
    assert got.dtype == torch.uint8 and tuple(got.shape) == run["shape"]
    top2 = np.sort(run["logits"], axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[decided], run["logits"].argmax(-1)[decided])


def test_deeplabv2_parameter_count_and_init(deeplabv2):
    """42-46 M parameters (``tests/test_models.py``), as many as JAX's; the
    ASPP head drawn from N(0, 0.01) with zero biases, the trunk fan-out
    Kaiming."""
    model = build_model(deeplabv2["cfg"], device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(v.size for k, v in deeplabv2["flat"].items() if k.startswith("params/"))
    assert 42e6 < n < 46e6, n
    state = init_model(model, torch.Generator().manual_seed(0))
    w = torch.cat([state[f"aspp.branch{i}.weight"].flatten() for i in range(4)])
    assert abs(float(w.std()) - 0.01) < 0.001 and abs(float(w.mean())) < 0.001
    assert all(not state[f"aspp.branch{i}.bias"].any() for i in range(4))
    w = state["resnet.layer3_5.conv2.conv.weight"]  # 256 -> 256, 3x3, fan-out
    assert abs(float(w.std()) - (2.0 / (256 * 9)) ** 0.5) < 0.1 * (2.0 / (256 * 9)) ** 0.5


def test_deeplabv2_output_stride_and_train_signature():
    model = DeepLabV2(19)
    init_model(model, torch.Generator().manual_seed(0))
    x = torch.zeros(1, 3, 65, 129)
    with torch.no_grad():
        assert tuple(model.eval()(x).shape) == (1, 19, 65, 129)
        assert tuple(model(x, upsample=False).shape) == (1, 19, 9, 17)
        out, n1, n2 = model.train()(x)
    assert tuple(out.shape) == (1, 19, 65, 129) and n1 is None and n2 is None


def _counting(monkeypatch):
    calls = []
    plain = k4.conv3x3

    def counting(x, w, *args, **kw):
        calls.append((x.shape[3], w.shape[3], kw["dilation"]))
        return plain(x, w, *args, **kw)

    monkeypatch.setattr(k4, "conv3x3", counting)
    return calls


# (config fields, K4 convs per forward, their count by dilation)
ROUTES = [(dict(), 14, {1: 14}), (dict(context_path="resnet101"), 31, {1: 31}),
          (dict(name="deeplabv2"), 33, {1: 7, 2: 23, 4: 3})]


@pytest.mark.parametrize("fields,convs,by_dilation", ROUTES)
def test_fused_conv3_routes_every_3x3_stride1_convbn_through_k4(monkeypatch, fields, convs, by_dilation):
    """One bf16 forward with ``fused_conv3`` launches K4 once per 3x3 /
    stride-1 ConvBN: 14 (R18), 31 (R101), 33 (DeepLabV2, dilated included);
    the FFM's is 256 + c3 + c4 -> 19 wide."""
    cfg = tconfig.ModelConfig(compute_dtype="bfloat16", **fields)
    model = build_model(cfg, device="cpu", fused_conv3=True)
    load_variables(model, init_model(model, torch.Generator().manual_seed(0)))
    fold_kernel_operands(model)
    assert sum(isinstance(m, ConvBN) and m.fused for m in model.modules()) == convs
    calls = _counting(monkeypatch)
    with torch.no_grad():
        out = model(torch.randn(1, 3, 65, 97).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert len(calls) == convs
    assert {d: sum(c[2] == d for c in calls) for d in by_dilation} == by_dilation
    if cfg.name == "bisenet":
        ffm = (256 + 1024 + 2048, 19) if cfg.context_path == "resnet101" else (256 + 256 + 512, 19)
        assert calls[-1][:2] == ffm


def test_ffm_input_stays_channels_last():
    """The FFM's concatenations keep a ``channels_last`` input in that
    layout, so K4's NHWC view of the FFM input needs no copy."""
    model = build_model(tconfig.ModelConfig(context_path="resnet101"), device="cpu")
    init_model(model, torch.Generator().manual_seed(0))
    seen = []
    model.ffm.convblock.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    with torch.no_grad():
        model(torch.randn(1, 3, 64, 96).to(memory_format=torch.channels_last))
    assert seen[0].is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("which", list(MODELS))
def test_bf16_serving_with_and_without_k4_gives_valid_masks(which):
    fields, shape = MODELS[which]
    cfg = tconfig.ModelConfig(compute_dtype="bfloat16", **fields)
    variables = init_model(build_model(cfg, device="cpu"), torch.Generator().manual_seed(1))
    frames = torch.from_numpy(_frames(3, shape))
    for fused in (False, True):
        serve = make_serving_fn(cfg, tconfig.AugmentConfig(), variables, "bf16", device="cpu",
                                fused_conv3=fused)
        masks = serve(frames)
        assert masks.dtype == torch.uint8 and tuple(masks.shape) == shape and int(masks.max()) < 19
        logits = serve.logits(frames)
        assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("flags", [["--model_name", "deeplabv2", "--precision", "f32"],
                                   ["--bisenet_context_path", "resnet101", "--precision", "bf16"]])
def test_predict_serves_the_r101_models(tmp_path, flags):
    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.RandomState(0)
    for name, size in [("a.png", (60, 40)), ("b.jpg", (48, 32))]:
        Image.fromarray(rng.randint(0, 256, (size[1], size[0], 3), np.uint8)).save(d / name)
    out = tmp_path / "masks"
    rc = predict_main(["--images", str(d), "--output", str(out), "--size", "32", "64",
                       "--batch_size", "2", "--device", "cpu", *flags])
    assert rc == 0
    for name, size in [("a", (60, 40)), ("b", (48, 32))]:
        mask = Image.open(out / f"{name}_trainids.png")
        assert mask.size == size and np.asarray(mask).max() < 19
    # int8, calibrated on the first batch, on the s8 conv's plain version
    rc = predict_main(["--images", str(d), "--output", str(tmp_path / "q"), "--size", "32", "64",
                       "--batch_size", "2", "--calib_batches", "1", "--device", "cpu",
                       "--precision", "int8", *flags[:2]])
    assert rc == 0
    for name, size in [("a", (60, 40)), ("b", (48, 32))]:
        mask = Image.open(tmp_path / "q" / f"{name}_trainids.png")
        assert mask.size == size and np.asarray(mask).max() < 19


@pytest.mark.parametrize("fields", [dict(context_path="resnet101"), dict(name="deeplabv2")])
def test_unported_r101_modes_raise(fields):
    """Training either model and int8-serving it are ported: the train
    model builds in train mode and returns ``(logits, aux1, aux2)``, and
    the calibration model calibrates. What still raises: K4 takes neither
    f32 nor a train graph, and an unknown model."""
    cfg = tconfig.ModelConfig(compute_dtype="bfloat16", **fields)
    train_model = build_model(dataclasses.replace(cfg, compute_dtype="float32"), device="cpu", train=True)
    init_model(train_model, torch.Generator().manual_seed(0))
    assert train_model.training
    with torch.no_grad():
        logits, *_ = train_model(torch.zeros(2, 3, 32, 64), aux=False)
    assert tuple(logits.shape) == (2, 19, 32, 64)
    assert sum(isinstance(m, QuantConv) for m in
               build_model(dataclasses.replace(cfg, quant="calib"), device="cpu").modules()) > 90
    variables = init_model(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    cal = calibrate(cfg, variables, [torch.zeros(1, 32, 64, 3)], device="cpu")
    assert sum(k.endswith(".in_absmax") for k in cal) > 90
    with pytest.raises(ValueError, match="bf16"):
        make_serving_fn(cfg, tconfig.AugmentConfig(), variables, "f32", device="cpu", fused_conv3=True)
    with pytest.raises(ValueError, match="eval path"):
        build_model(tconfig.ModelConfig(compute_dtype="bfloat16"), device="cpu", train=True, fused_conv3=True)
    with pytest.raises(ValueError, match="unknown model"):
        build_model(dataclasses.replace(cfg, name="unet"), device="cpu")


def test_deeplabv2_preset_matches_jax():
    port, ref = tconfig.get_preset("deeplabv2_cityscapes"), jconfig.get_preset("deeplabv2_cityscapes")

    def match(p, r):
        for f in dataclasses.fields(p):
            if f.name in tconfig.PORT_ONLY_FIELDS:  # SegFormer's, which JAX lacks
                continue
            value = getattr(p, f.name)
            if dataclasses.is_dataclass(value):
                match(value, getattr(r, f.name))
            else:
                assert value == getattr(r, f.name), f.name

    match(port, ref)
    assert port.model.name == "deeplabv2" and port.train_size == ref.train_size
