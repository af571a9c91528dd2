"""The port's serving path: ``make_serving_fn`` against the JAX package's,
the port's predict CLI, and its independence from JAX.

Tolerance of the mask comparison: f32 masks must equal JAX's at every
pixel whose top-2 JAX logits lie more than 1e-3 apart. Within that margin
the f32 rounding differences of the two frameworks' convs (see
``tests/test_torch_bisenet.py``) may legitimately flip the argmax.
"""

import os
import subprocess
import sys

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
from rtda_semanticsegmentation_tpu.serving import make_serving_fn as jmake_serving_fn
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.cli.predict import main as predict_main
from rtda_semanticsegmentation_tpu_torch.models.convert import from_jax_variables
from rtda_semanticsegmentation_tpu_torch.models.quantize import calibrate
from rtda_semanticsegmentation_tpu_torch.ops.augment import normalize_u8
from rtda_semanticsegmentation_tpu_torch.serving import make_serving_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 64, 128


@pytest.fixture(scope="module")
def shared():
    jcfg = jconfig.ModelConfig(compute_dtype="float32")
    jmodel = jbuild_model(jcfg)
    variables = jinit_model(jmodel, jax.random.PRNGKey(1), (1, H, W, 3), train=False)
    frames = np.random.RandomState(11).randint(0, 256, (B, H, W, 3), np.uint8)
    aug = jconfig.AugmentConfig()
    masks = np.asarray(jmake_serving_fn(jcfg, aug, variables, "f32")(jnp.asarray(frames)))
    logits = np.asarray(jmodel.apply(variables, jnormalize_u8(jnp.asarray(frames), aug), False))
    flat = flax.traverse_util.flatten_dict(variables, sep="/")
    return dict(frames=frames, masks=masks, logits=logits,
                variables=from_jax_variables({k: np.array(v) for k, v in flat.items()}))


def test_f32_masks_match_jax_outside_near_ties(shared):
    serve = make_serving_fn(tconfig.ModelConfig(compute_dtype="float32"), tconfig.AugmentConfig(),
                            shared["variables"], "f32")
    got = serve(torch.from_numpy(shared["frames"]))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, H, W)
    top2 = np.sort(shared["logits"], axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[decided], shared["masks"][decided])


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_bf16_and_int8_serving_give_valid_masks(shared, precision):
    cfg = tconfig.ModelConfig(compute_dtype="bfloat16")
    variables = shared["variables"]
    if precision == "int8":
        with pytest.raises(ValueError, match="calibrate"):
            make_serving_fn(cfg, tconfig.AugmentConfig(), variables, "int8")
        calib = [normalize_u8(torch.from_numpy(shared["frames"]), tconfig.AugmentConfig())]
        variables = calibrate(cfg, variables, calib)
    serve = make_serving_fn(cfg, tconfig.AugmentConfig(), variables, precision)
    masks = serve(torch.from_numpy(shared["frames"]))
    assert masks.dtype == torch.uint8 and tuple(masks.shape) == (B, H, W)
    assert int(masks.max()) < 19
    logits = serve.logits(torch.from_numpy(shared["frames"]))
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())
    assert torch.equal(masks, logits.argmax(1).to(torch.uint8))


@pytest.fixture()
def image_dir(tmp_path):
    rng = np.random.RandomState(0)
    d = tmp_path / "frames"
    d.mkdir()
    for name, size in [("a.png", (60, 40)), ("b.png", (48, 32)), ("c.jpg", (64, 48))]:
        Image.fromarray(rng.randint(0, 256, (size[1], size[0], 3), np.uint8)).save(d / name)
    (d / "notes.txt").write_text("not an image")
    return d


def test_predict_f32_writes_masks_at_input_size(image_dir, tmp_path):
    out = tmp_path / "masks"
    rc = predict_main(["--images", str(image_dir), "--output", str(out),
                       "--size", "32", "64", "--batch_size", "2", "--precision", "f32"])
    assert rc == 0
    for name, size in [("a", (60, 40)), ("b", (48, 32)), ("c", (64, 48))]:
        mask = Image.open(out / f"{name}_trainids.png")
        assert mask.mode == "L" and mask.size == size
        assert np.asarray(mask).max() < 19
        color = Image.open(out / f"{name}_color.png")
        assert color.size == size and color.mode == "RGB"
    assert not (out / "notes_trainids.png").exists()


def test_predict_int8_overlay_model_size(image_dir, tmp_path):
    out = tmp_path / "masks_q"
    rc = predict_main(["--images", str(image_dir), "--output", str(out),
                       "--size", "32", "64", "--batch_size", "2", "--precision", "int8",
                       "--calib_batches", "1", "--overlay", "--no_resize_back"])
    assert rc == 0
    for name in ("a", "b", "c"):
        assert Image.open(out / f"{name}_trainids.png").size == (64, 32)
        assert Image.open(out / f"{name}_overlay.png").size == (64, 32)


@pytest.mark.parametrize("flag", [["--checkpoint_dir", "ckpt"], ["--artifact", "art"]])
def test_predict_unported_sources_raise(image_dir, tmp_path, flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        predict_main(["--images", str(image_dir), "--output", str(tmp_path / "o"), *flag])


def test_port_imports_no_jax():
    """The serving path, the CLI and chip_smoke.py load no jax/flax/optax;
    the serving path and chip_smoke.py load nothing of the JAX package."""
    code = (
        "import sys\n"
        "import chip_smoke, rtda_semanticsegmentation_tpu_torch.serving\n"
        "import rtda_semanticsegmentation_tpu_torch.models.quantize\n"
        "jax_pkg = [m for m in sys.modules if m.split('.')[0] == 'rtda_semanticsegmentation_tpu']\n"
        "import rtda_semanticsegmentation_tpu_torch.cli.predict\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax')]\n"
        "print(jax_pkg, bad)\n"
        "sys.exit(1 if bad or jax_pkg else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_port(tmp_path, alone):
    """No CUDA device (this runner), or the script alone in a directory:
    a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
