"""The port's torch weight converter (``models/convert.py``'s torch-side
functions, ``cli/convert_torch_weights.py``) against the JAX package's.

The torch mirrors of the reference modules are ``tests/test_convert.py``'s.
The port's ``.npz`` must hold the same keys and the same arrays as the JAX
converter's, bit for bit; loaded through ``load_npz_into_state`` it must
reproduce the mirror's f32 eval forward within 1e-4 (absolute and relative;
``atol=2e-4, rtol=1e-3`` for the whole BiSeNet, as ``test_convert.py``
holds the JAX model), the two frameworks' convs summing in another order.
"""

import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu.cli import convert_torch_weights as jcli
from rtda_semanticsegmentation_tpu.models import convert as jconvert
from rtda_semanticsegmentation_tpu_torch.cli import convert_torch_weights as tcli
from rtda_semanticsegmentation_tpu_torch.config import ModelConfig
from rtda_semanticsegmentation_tpu_torch.models import convert as tconvert
from rtda_semanticsegmentation_tpu_torch.models.factory import (
    build_discriminator,
    build_model,
    init_discriminator,
    init_model,
)
from test_convert import TorchBiSeNet, TorchFCDiscriminator, TorchResNet18Features


def _randomize_bn(net):
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
    return net.eval()


def _numpy_state(net) -> dict:
    return {k: v.numpy() for k, v in net.state_dict().items()}


def _assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def r18():
    torch.manual_seed(0)
    return _randomize_bn(TorchResNet18Features())


@pytest.fixture(scope="module")
def bisenet():
    torch.manual_seed(1)
    return _randomize_bn(TorchBiSeNet())


def _f32_model(name="bisenet"):
    cfg = ModelConfig(name=name, compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    return model, init_model(model, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("prefixed", [False, True])
def test_backbone_npz_equals_jax_and_reproduces_the_trunk(r18, tmp_path, prefixed):
    """torchvision keys, and the caffe-style 'Scale.'-prefixed ones."""
    state = _numpy_state(r18)
    if prefixed:
        state = {f"Scale.{k}": v for k, v in state.items()}
        assert tconvert.looks_prefixed(state) and tconvert.strip_key_prefix(state).keys() == r18.state_dict().keys()
    arrays = tconvert.convert_torch_checkpoint(state, "bisenet", 18)
    _assert_same_arrays(arrays, jconvert.convert_torch_checkpoint(state, "bisenet", 18))
    assert len(arrays) == 100
    path = tmp_path / "r18.npz"
    np.savez(path, **arrays)
    model, variables = _f32_model()
    loaded = tconvert.load_npz_into_state(variables, str(path), "bisenet")
    model.load_state_dict(loaded)
    x = np.random.RandomState(0).rand(1, 3, 64, 96).astype(np.float32)
    with torch.no_grad():
        c3, c4 = model.eval().context_path.resnet(torch.from_numpy(x))
        t3, t4 = r18(torch.from_numpy(x))
    np.testing.assert_allclose(c3.numpy(), t3.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(c4.numpy(), t4.numpy(), rtol=1e-4, atol=1e-4)
    # the graft touches the backbone only
    key = "spatial_path.convblock1.conv.weight"
    assert torch.equal(loaded[key], variables[key])


def test_full_bisenet_npz_equals_jax_and_reproduces_the_forward(bisenet, tmp_path):
    state = _numpy_state(bisenet)
    arrays = tconvert.convert_full_torch_checkpoint(state, "bisenet", 18)
    _assert_same_arrays(arrays, jconvert.convert_full_torch_checkpoint(state, "bisenet", 18))
    path = tmp_path / "full.npz"
    np.savez(path, **arrays)
    model, variables = _f32_model()
    model.load_state_dict(tconvert.load_npz_into_state(variables, str(path), "bisenet"))
    x = np.random.RandomState(0).rand(1, 3, 64, 128).astype(np.float32)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(x))
        ref = bisenet(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-4, rtol=1e-3)
    # a train model takes the supervision heads too
    train = build_model(ModelConfig(compute_dtype="float32"), device="cpu", train=True)
    grafted = tconvert.load_npz_into_state(init_model(train, torch.Generator().manual_seed(0)), str(path),
                                           "bisenet")
    np.testing.assert_array_equal(grafted["supervision1.weight"].numpy(), state["supervision1.weight"])


def test_deeplab_aspp_npz_equals_jax():
    rng = np.random.RandomState(2)
    state = {}
    for i in range(4):
        state[f"layer6.conv2d_list.{i}.weight"] = rng.randn(19, 2048, 3, 3).astype(np.float32)
        state[f"layer6.conv2d_list.{i}.bias"] = rng.randn(19).astype(np.float32)
    arrays = tconvert.convert_full_torch_checkpoint(state, "deeplabv2", 101)
    _assert_same_arrays(arrays, jconvert.convert_full_torch_checkpoint(state, "deeplabv2", 101))
    assert arrays["params/aspp/branch0/kernel"].shape == (3, 3, 2048, 19)


def test_discriminator_npz_equals_jax_and_reproduces_the_forward(tmp_path):
    torch.manual_seed(3)
    net = TorchFCDiscriminator().eval()
    container = {"model_G_state_dict": {}, "model_D_state_dict": _numpy_state(net)}
    state = tconvert.unwrap_reference_checkpoint(container, which="D")
    arrays = tconvert.convert_full_torch_checkpoint(state, "discriminator", 18)
    _assert_same_arrays(arrays, jconvert.convert_full_torch_checkpoint(state, "discriminator", 18))
    path = tmp_path / "d.npz"
    np.savez(path, **arrays)
    disc = build_discriminator(ModelConfig(compute_dtype="float32"), device="cpu")
    variables = init_discriminator(disc, torch.Generator().manual_seed(0))
    disc.load_state_dict(tconvert.load_npz_into_state(variables, str(path), "discriminator"))
    x = np.random.RandomState(1).rand(2, 19, 64, 64).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(disc(torch.from_numpy(x)).numpy(), net(torch.from_numpy(x)).numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_unwrap_reference_checkpoint_matches_jax():
    sd = {"conv.weight": np.zeros(1)}
    for obj, which in (({"model_state_dict": sd}, "G"), ({"model_G_state_dict": sd, "model_D_state_dict": {}}, "G"),
                       ({"state_dict": sd}, "G"), (sd, "G"), (sd, "D")):
        assert tconvert.unwrap_reference_checkpoint(obj, which) is jconvert.unwrap_reference_checkpoint(obj, which)
    with pytest.raises(ValueError, match="not an adversarial checkpoint"):
        tconvert.unwrap_reference_checkpoint({"model_state_dict": sd}, which="D")
    with pytest.raises(ValueError, match="model_D_state_dict"):
        jconvert.unwrap_reference_checkpoint({"model_state_dict": sd}, which="D")
    assert list(tconvert._torch_resnet_key_map(101)) == list(jconvert._torch_resnet_key_map(101))


def test_unknown_key_raises(tmp_path):
    bad = tmp_path / "bad.npz"
    np.savez(bad, **{"params/nonexistent/kernel": np.zeros((1, 1, 1, 1))})
    _, variables = _f32_model()
    with pytest.raises(KeyError, match="nonexistent"):
        tconvert.load_npz_into_state(variables, str(bad), "bisenet")


@pytest.mark.parametrize("mode", ["backbone", "full", "discriminator"])
def test_cli_writes_the_jax_cli_npz(r18, bisenet, tmp_path, mode):
    """The same .pth through both CLIs gives the same .npz; the port reads
    a bare state_dict and a training container (tensors, ints and optimizer
    state) with ``weights_only=True``."""
    if mode == "backbone":
        obj, flags = r18.state_dict(), ["--model", "bisenet", "--depth", "18"]
    elif mode == "full":
        obj = {"model_state_dict": bisenet.state_dict(), "epoch": 3,
               "optimizer_state_dict": {"state": {}, "param_groups": [{"lr": 0.01}]}}
        flags = ["--model", "bisenet", "--full"]
    else:
        torch.manual_seed(4)
        obj = {"model_G_state_dict": {}, "model_D_state_dict": TorchFCDiscriminator().state_dict()}
        flags = ["--model", "discriminator"]
    pth = tmp_path / "ckpt.pth"
    torch.save(obj, pth)
    tcli.main(["--torch_checkpoint", str(pth), "--output", str(tmp_path / "port.npz"), *flags])
    jcli.main(["--torch_checkpoint", str(pth), "--output", str(tmp_path / "jax.npz"), *flags])
    port, ref = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    _assert_same_arrays({k: port[k] for k in port.files}, {k: ref[k] for k in ref.files})


def test_read_torch_checkpoint_falls_back_for_pickled_objects(tmp_path):
    """A container that pickles an object ``weights_only`` refuses still
    loads (a trusted reference file)."""
    pth = tmp_path / "ns.pth"
    torch.save({"model_state_dict": {"w": torch.ones(2)}, "args": _Args()}, pth)
    with pytest.raises(Exception):
        torch.load(pth, weights_only=True)
    obj = tconvert.read_torch_checkpoint(str(pth))
    assert torch.equal(obj["model_state_dict"]["w"], torch.ones(2))


class _Args:
    lr = 0.01


def test_cli_rejects_depth_for_discriminator(tmp_path):
    with pytest.raises(SystemExit):
        tcli.main(["--torch_checkpoint", str(tmp_path / "x.pth"), "--model", "discriminator", "--depth", "18",
                   "--output", str(tmp_path / "o.npz")])
