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
from rtda_semanticsegmentation_tpu.cli import predict as jpredict
from rtda_semanticsegmentation_tpu.data.labels import train_ids_to_rgb as jtrain_ids_to_rgb
from rtda_semanticsegmentation_tpu.models.factory import build_model as jbuild_model
from rtda_semanticsegmentation_tpu.models.factory import init_model as jinit_model
from rtda_semanticsegmentation_tpu.ops.augment import normalize_u8 as jnormalize_u8
from rtda_semanticsegmentation_tpu.serving import make_serving_fn as jmake_serving_fn
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.cli import predict as tpredict
from rtda_semanticsegmentation_tpu_torch.cli.export import main as export_main
from rtda_semanticsegmentation_tpu_torch.cli.predict import main as predict_main
from rtda_semanticsegmentation_tpu_torch.data.labels import train_ids_to_rgb
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
                            shared["variables"], "f32", device="cpu")
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
            make_serving_fn(cfg, tconfig.AugmentConfig(), variables, "int8", device="cpu")
        calib = [normalize_u8(torch.from_numpy(shared["frames"]), tconfig.AugmentConfig())]
        variables = calibrate(cfg, variables, calib, device="cpu")
    serve = make_serving_fn(cfg, tconfig.AugmentConfig(), variables, precision, device="cpu")
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
                       "--size", "32", "64", "--batch_size", "2", "--precision", "f32", "--device", "cpu"])
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
                       "--calib_batches", "1", "--overlay", "--no_resize_back", "--device", "cpu"])
    assert rc == 0
    for name in ("a", "b", "c"):
        assert Image.open(out / f"{name}_trainids.png").size == (64, 32)
        assert Image.open(out / f"{name}_overlay.png").size == (64, 32)


@pytest.mark.parametrize("flag", [["--checkpoint_dir", "ckpt"], ["--artifact", "art"]])
def test_predict_unported_sources_raise(image_dir, tmp_path, flag):
    """``--checkpoint_dir`` raises only when the directory holds no
    checkpoint (``tests/test_torch_cli.py`` predicts from a trained one).
    ``--artifact`` is ported: an artifact that ``cli/export.main`` wrote
    (f32, batch pinned at 2, so the tail batch is padded) serves PNGs equal
    to those of predict without it on the same seeded weights."""
    if flag[0] == "--checkpoint_dir":
        with pytest.raises(FileNotFoundError, match="no 'best' checkpoint"):
            predict_main(["--images", str(image_dir), "--output", str(tmp_path / "o"), "--device", "cpu",
                          "--checkpoint_dir", str(tmp_path / "ckpt")])
        return
    art = tmp_path / "art"
    common = ["--size", "32", "64", "--precision", "f32", "--device", "cpu"]
    assert export_main(["--output", str(art), "--batch", "2", *common]) == 0
    assert predict_main(["--images", str(image_dir), "--output", str(tmp_path / "a"), "--artifact", str(art),
                         "--device", "cpu"]) == 0
    assert predict_main(["--images", str(image_dir), "--output", str(tmp_path / "e"), "--batch_size", "2",
                         *common]) == 0
    names = sorted(os.listdir(tmp_path / "e"))
    assert names == sorted(os.listdir(tmp_path / "a")) and len(names) == 6
    for name in names:
        got, want = Image.open(tmp_path / "a" / name), Image.open(tmp_path / "e" / name)
        assert got.size == want.size and got.mode == want.mode
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _flags(parser):
    return {a.option_strings[0]: (a.dest, a.default, a.choices, a.nargs, a.type, a.required)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_predict_copies_match_jax(image_dir):
    """The port's own copies of the JAX CLI's parser, image collection, stem
    de-duplication and trainId palette agree with the originals; the port
    adds only ``--device``."""
    port, ref = _flags(tpredict.build_parser()), _flags(jpredict.build_parser())
    assert port.pop("--device") == ("device", "cuda", ("cuda", "cpu"), None, None, False)
    assert port == ref
    assert tpredict.collect_images(str(image_dir)) == jpredict.collect_images(str(image_dir))
    paths = ["x/a.png", "y/a.jpg", "b.png", "z/a.bmp"]
    assert tpredict._unique_stems(paths) == jpredict._unique_stems(paths)
    ids = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(train_ids_to_rgb(ids), jtrain_ids_to_rgb(ids))


def test_predict_needs_a_card_unless_device_cpu(image_dir, tmp_path, monkeypatch):
    """``--device cuda`` (the default) raises without a CUDA device; it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        predict_main(["--images", str(image_dir), "--output", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


PORT_ENTRY_MODULES = (
    "rtda_semanticsegmentation_tpu_torch.serving",
    "rtda_semanticsegmentation_tpu_torch.models.quantize",
    "rtda_semanticsegmentation_tpu_torch.cli.predict",
    "rtda_semanticsegmentation_tpu_torch.kernels.lovasz",
    "rtda_semanticsegmentation_tpu_torch.kernels.conv4x4",
    "rtda_semanticsegmentation_tpu_torch.kernels.conv3x3",
    "rtda_semanticsegmentation_tpu_torch.kernels.upsample",
    "rtda_semanticsegmentation_tpu_torch.models.discriminator",
    "rtda_semanticsegmentation_tpu_torch.models.deeplabv2",
    "rtda_semanticsegmentation_tpu_torch.ops.losses",
    "rtda_semanticsegmentation_tpu_torch.ops.augment",
    "rtda_semanticsegmentation_tpu_torch.train.steps",
    "rtda_semanticsegmentation_tpu_torch.ops.metrics",
    "rtda_semanticsegmentation_tpu_torch.data.datasets",
    "rtda_semanticsegmentation_tpu_torch.data.loader",
    "rtda_semanticsegmentation_tpu_torch.train.evaluate",
    "rtda_semanticsegmentation_tpu_torch.train.checkpoint",
    "rtda_semanticsegmentation_tpu_torch.train.loop",
    "rtda_semanticsegmentation_tpu_torch.obs.logging",
    "rtda_semanticsegmentation_tpu_torch.obs.profiler",
    "rtda_semanticsegmentation_tpu_torch.obs.spans",
    "rtda_semanticsegmentation_tpu_torch.obs.summary",
    "rtda_semanticsegmentation_tpu_torch.parallel",
    "rtda_semanticsegmentation_tpu_torch.parallel.mesh",
    "rtda_semanticsegmentation_tpu_torch.parallel.multihost",
    "rtda_semanticsegmentation_tpu_torch.parallel.tp",
    "rtda_semanticsegmentation_tpu_torch.cli.common",
    "rtda_semanticsegmentation_tpu_torch.cli.train",
    "rtda_semanticsegmentation_tpu_torch.cli.train_adversarial",
    "rtda_semanticsegmentation_tpu_torch.cli.export",
    "rtda_semanticsegmentation_tpu_torch.cli.convert_torch_weights",
    "rtda_semanticsegmentation_tpu_torch.cli.debug_dataset",
    "rtda_semanticsegmentation_tpu_torch.data.native",
    "rtda_semanticsegmentation_tpu_torch.data.cache",
    "rtda_semanticsegmentation_tpu_torch.data.preprocess",
    "chip_smoke",
)


# one rank of a 2-rank tensor-parallel run (--mesh_model 2) of cli/train on
# the CPU: it exits non-zero if it loaded anything of JAX
RANK_CODE = (
    "import sys\n"
    "from rtda_semanticsegmentation_tpu_torch.cli import train\n"
    "report = train.main(['--preset', 'bisenet_source_small', '--train_dataset', 'synthetic',\n"
    "    '--val_dataset', 'synthetic', '--train_size', '32', '32', '--eval_size', '32', '32',\n"
    "    '--batch_size', '4', '--eval_batch_size', '4', '--epochs', '1', '--steps_per_epoch', '2',\n"
    "    '--compute_dtype', 'float32', '--num_workers', '1', '--device', 'cpu', '--no_perf',\n"
    "    '--log_backend', 'jsonl', '--log_dir', 'ROOT/dp_logs', '--checkpoint_dir', 'ROOT/dp_ckpt',\n"
    "    '--run_name', 'dp', '--mesh_model', '2'])\n"
    "mesh = report['trainer'].mesh\n"
    "assert report['global_step'] == 2 and (mesh.world, mesh.model_size) == (2, 2), report['global_step']\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in\n"
    "       ('jax', 'jaxlib', 'flax', 'optax', 'rtda_semanticsegmentation_tpu')]\n"
    "sys.exit(f'a rank loads {bad[:5]}' if bad else 0)\n"
)


def test_port_imports_no_jax(tmp_path):
    """After each import of the port's modules and scripts, after the
    adversarial train step and its fused discriminator are built, after
    DeepLabV2 is built with its 3x3 convs on K4, after the DeepLabV2 train
    step with remat and its frozen-BatchNorm optimizer and the R101 int8
    models (frozen and not) are built, after a 1-epoch, 2-step
    ``run_experiment`` on the CPU (synthetic data, validation, checkpoints,
    the report), after an export through ``cli/export`` and its load, a
    run of the converter CLI, and a native decode through the decoded-sample
    cache, no jax, jaxlib, flax or optax module and nothing of the JAX
    package is loaded; nor in either rank of a 2-rank (gloo) run of
    ``cli/train --mesh_model 2`` on the CPU, which trains 2 steps with the
    wide convs sharded over both ranks (``parallel/tp.py``)."""
    code = (
        "import importlib, sys\n"
        "def check(what):\n"
        "    bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "           ('jax', 'jaxlib', 'flax', 'optax', 'rtda_semanticsegmentation_tpu')]\n"
        "    if bad:\n"
        "        sys.exit(f'{what} loads {bad[:5]}')\n"
        f"for name in {PORT_ENTRY_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    check(name)\n"
        "from rtda_semanticsegmentation_tpu_torch.config import get_preset\n"
        "from rtda_semanticsegmentation_tpu_torch.models.factory import build_discriminator\n"
        "from rtda_semanticsegmentation_tpu_torch.train.steps import make_train_step\n"
        "cfg = get_preset('bisenet_adversarial_lovasz')\n"
        "build_discriminator(cfg.model, device='cpu', fused_conv1=True)\n"
        "make_train_step(cfg, lambda t: 1e-4, lambda t: 2.5e-5)\n"
        "check('the adversarial step')\n"
        "import dataclasses as dc\n"
        "from rtda_semanticsegmentation_tpu_torch.config import ModelConfig\n"
        "from rtda_semanticsegmentation_tpu_torch.models.factory import build_model\n"
        "build_model(ModelConfig(name='deeplabv2'), device='cpu', fused_conv3=True)\n"
        "check('DeepLabV2 with K4')\n"
        "from rtda_semanticsegmentation_tpu_torch.models.quantize import quantized_model\n"
        "from rtda_semanticsegmentation_tpu_torch.train.optim import build_generator_tx\n"
        "cfg = get_preset('deeplabv2_cityscapes')\n"
        "cfg = cfg.replace(train=dc.replace(cfg.train, remat=True))\n"
        "g = build_model(cfg.model, device='cpu', train=True)\n"
        "build_generator_tx(cfg.optimizer, g, freeze_bn=True)\n"
        "make_train_step(cfg, lambda t: 2.5e-4)\n"
        "check('the DeepLabV2 train step with remat')\n"
        "quantized_model(ModelConfig(name='deeplabv2'), frozen=False, device='cpu')\n"
        "quantized_model(ModelConfig(context_path='resnet101'), device='cpu')\n"
        "check('the R101 int8 models')\n"
        "from rtda_semanticsegmentation_tpu_torch.train.loop import run_experiment\n"
        "cfg = get_preset('bisenet_source_small')\n"
        f"root = {str(tmp_path)!r}\n"
        "cfg = cfg.replace(\n"
        "    data=dc.replace(cfg.data, train_dataset='synthetic', val_dataset='synthetic',\n"
        "                    train_size_override=(32, 32), eval_size_override=(32, 32),\n"
        "                    synthetic_length=4, num_workers=1),\n"
        "    model=dc.replace(cfg.model, compute_dtype='float32'),\n"
        "    train=dc.replace(cfg.train, epochs=1, steps_per_epoch=2, checkpoint_dir=root + '/ckpt'),\n"
        "    obs=dc.replace(cfg.obs, backend='jsonl', log_dir=root + '/logs'))\n"
        "report = run_experiment(cfg, run_name='nojax', measure_performance=False, verbose=False,\n"
        "                        device='cpu')\n"
        "assert report['global_step'] == 2, report['global_step']\n"
        "check('run_experiment')\n"
        "import shutil\n"
        "shutil.rmtree(root + '/ckpt')\n"
        "import numpy as np\n"
        "from PIL import Image\n"
        "from rtda_semanticsegmentation_tpu_torch.cli import export, convert_torch_weights\n"
        "from rtda_semanticsegmentation_tpu_torch.serving import load_artifact\n"
        "assert export.main(['--output', root + '/art', '--size', '32', '64', '--device', 'cpu']) == 0\n"
        "fn, _ = load_artifact(root + '/art', device='cpu')\n"
        "assert tuple(fn(np.zeros((1, 32, 64, 3), np.uint8)).shape) == (1, 32, 64)\n"
        "check('an export and a load')\n"
        "import torch\n"
        "torch.save({'conv1.weight': torch.ones(64, 3, 7, 7)}, root + '/r.pth')\n"
        "convert_torch_weights.main(['--torch_checkpoint', root + '/r.pth', '--model', 'bisenet',\n"
        "                            '--output', root + '/r.npz'])\n"
        "check('the converter CLI')\n"
        "from rtda_semanticsegmentation_tpu_torch.data import native\n"
        "from rtda_semanticsegmentation_tpu_torch.data.cache import DecodedCacheDataset\n"
        "from rtda_semanticsegmentation_tpu_torch.data.datasets import GTA5Dataset\n"
        "import os\n"
        "for sub in ('images', 'labels_trainids'):\n"
        "    os.makedirs(f'{root}/gta/{sub}')\n"
        "Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(root + '/gta/images/a.png')\n"
        "Image.fromarray(np.zeros((8, 8), np.uint8)).save(root + '/gta/labels_trainids/a.png')\n"
        "ds = GTA5Dataset(root + '/gta', size=(4, 4), native_decode='on')\n"
        "DecodedCacheDataset(ds, root + '/cache').load(0)\n"
        "assert native.available()\n"
        "check('the native decode and the cache')\n"
        "import socket, subprocess\n"
        "with socket.socket() as s:\n"
        "    s.bind(('localhost', 0))\n"
        "    port = s.getsockname()[1]\n"
        f"rank_code = {RANK_CODE!r}.replace('ROOT', root)\n"
        "env = dict(os.environ, MASTER_ADDR='localhost', MASTER_PORT=str(port), WORLD_SIZE='2', OMP_NUM_THREADS='1')\n"
        "procs = [subprocess.Popen([sys.executable, '-c', rank_code], env={**env, 'RANK': str(r), 'LOCAL_RANK': str(r)},\n"
        "                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]\n"
        "outs = [p.communicate(timeout=200)[0] for p in procs]\n"
        "if any(p.returncode for p in procs):\n"
        "    sys.exit('a 2-rank run failed: ' + ' | '.join(o[-2000:] for o in outs))\n"
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
