"""The port's serving artifacts (``serving.export_serving`` / ``save_artifact``
/ ``load_artifact``, ``cli/export.py``) and K3 and K4 as custom ops.

On the CPU at 32x64, the size of the JAX package's ``tests/test_serving.py``,
with one intra-op thread. Tolerances: artifact masks equal the eager
``make_serving_fn`` masks exactly (both run the same ops); against JAX's own
f32 artifact the masks must be equal at every pixel whose top-2 JAX logits
lie more than 1e-3 apart (``tests/test_torch_serving.py``'s rule: the two
frameworks' f32 convs round differently, which may flip a near tie).
"""

import json
import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu import serving as jserving
from rtda_semanticsegmentation_tpu.models.factory import build_model as jbuild_model
from rtda_semanticsegmentation_tpu.models.factory import init_model as jinit_model
from rtda_semanticsegmentation_tpu.ops.augment import normalize_u8 as jnormalize_u8
from rtda_semanticsegmentation_tpu_torch.config import AugmentConfig, ModelConfig
from rtda_semanticsegmentation_tpu_torch.kernels import conv3x3 as k4
from rtda_semanticsegmentation_tpu_torch.kernels import int8_conv as k3
from rtda_semanticsegmentation_tpu_torch.models.convert import from_jax_variables
from rtda_semanticsegmentation_tpu_torch.models.layers import ConvBN, QuantConv
from rtda_semanticsegmentation_tpu_torch.models.quantize import calibrate
from rtda_semanticsegmentation_tpu_torch.ops.augment import normalize_u8
from rtda_semanticsegmentation_tpu_torch.serving import (
    ARTIFACT_GRAPH,
    export_serving,
    load_artifact,
    make_serving_fn,
    save_artifact,
    serving_module,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 64
CFG = ModelConfig(compute_dtype="bfloat16")
AUG = AugmentConfig()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bridged():
    """R18 variables from the JAX package's init, the frames, JAX's f32 masks
    from its own artifact and JAX's f32 logits."""
    jcfg = jconfig.ModelConfig(compute_dtype="float32")
    jmodel = jbuild_model(jcfg)
    variables = jinit_model(jmodel, jax.random.PRNGKey(0), (1, H, W, 3), train=False)
    frames = np.random.RandomState(5).randint(0, 256, (3, H, W, 3), np.uint8)
    aug = jconfig.AugmentConfig()
    blob, _ = jserving.export_serving(jcfg, aug, variables, H, W, precision="f32", platforms=("cpu",))
    exported = jax.export.deserialize(blob)
    masks = np.asarray(exported.call(jnp.asarray(frames)))
    logits = np.asarray(jmodel.apply(variables, jnormalize_u8(jnp.asarray(frames), aug), False))
    flat = flax.traverse_util.flatten_dict(variables, sep="/")
    port_vars = from_jax_variables({k: np.array(v) for k, v in flat.items()})
    calibrated = calibrate(CFG, port_vars, [normalize_u8(torch.from_numpy(frames[:2]), AUG)], device="cpu")
    return dict(frames=torch.from_numpy(frames), jax_masks=masks, jax_logits=logits, variables=port_vars,
                calibrated=calibrated)


# (precision, fused_conv3) of the symbolic-batch artifacts
KINDS = [("bf16", False), ("f32", False), ("int8", False), ("bf16", True)]


@pytest.fixture(scope="module")
def artifacts(bridged, tmp_path_factory):
    """Each kind exported with a symbolic batch, saved and loaded on the
    CPU: {kind: (loaded fn, meta, ExportedProgram, the eager serve fn)}."""
    out = {}
    for precision, fused in KINDS:
        variables = bridged["calibrated" if precision == "int8" else "variables"]
        exported, meta = export_serving(CFG, AUG, variables, H, W, precision=precision, fused_conv3=fused,
                                        device="cpu")
        path = str(tmp_path_factory.mktemp("art") / f"{precision}{'_k4' if fused else ''}")
        save_artifact(path, exported, meta)
        fn, loaded_meta = load_artifact(path, device="cpu")
        assert loaded_meta == json.loads(json.dumps(meta))
        eager = make_serving_fn(CFG, AUG, variables, precision, device="cpu", fused_conv3=fused)
        out[(precision, fused)] = (fn, loaded_meta, exported, eager, path)
    return out


def _targets(exported) -> list:
    return [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]


@pytest.mark.parametrize("kind", KINDS, ids=["bf16", "f32", "int8", "bf16_fused_conv3"])
def test_round_trip_masks_equal_eager_serving(artifacts, bridged, kind):
    """Symbolic batch: b1 and b3 served, numpy and torch inputs; the masks
    equal ``make_serving_fn``'s bit for bit."""
    fn, _, _, eager, _ = artifacts[kind]
    frames = bridged["frames"]
    for b in (1, 3):
        got = fn(frames[:b].numpy())
        assert got.dtype == torch.uint8 and tuple(got.shape) == (b, H, W) and got.device.type == "cpu"
        assert torch.equal(got, eager(frames[:b]))
    assert torch.equal(fn(frames), fn(frames.numpy()))


def test_f32_artifact_agrees_with_jax_artifact(artifacts, bridged):
    fn = artifacts[("f32", False)][0]
    got = fn(bridged["frames"]).numpy()
    top2 = np.sort(bridged["jax_logits"], axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got[decided], bridged["jax_masks"][decided])


def test_graphs_hold_one_op_node_per_kernel_call(artifacts, bridged):
    """The int8 graph: one K3 node per QuantConv and a float conv only for
    the convs left in bf16; the fused_conv3 graph: one K4 node per fused
    ConvBN. No graph holds the other kernel's op."""
    int8_model = serving_module(CFG, AUG, bridged["calibrated"], "int8", device="cpu").model
    n_quant = sum(isinstance(m, QuantConv) for m in int8_model.modules())
    fused_model = serving_module(CFG, AUG, bridged["variables"], "bf16", device="cpu", fused_conv3=True).model
    n_fused = sum(isinstance(m, ConvBN) and m.fused for m in fused_model.modules())
    assert (n_quant, n_fused) == (15, 14)
    census = {kind: _targets(artifacts[kind][2]) for kind in KINDS}

    def count(kind, name):
        return sum(t == name for t in census[kind])

    convs = {kind: sum(t.startswith("aten.conv") for t in census[kind]) for kind in KINDS}
    assert count(("int8", False), "rtda_torch.int8_conv.default") == n_quant
    assert convs[("int8", False)] == convs[("bf16", False)] - n_quant
    assert count(("bf16", True), "rtda_torch.conv3x3.default") == n_fused
    assert convs[("bf16", True)] == convs[("bf16", False)] - n_fused
    assert count(("int8", False), "rtda_torch.conv3x3.default") == 0
    for kind in (("bf16", False), ("f32", False)):
        assert not any(t.startswith("rtda_torch") for t in census[kind])
    assert count(("bf16", True), "rtda_torch.int8_conv.default") == 0


def test_meta_contents(artifacts):
    _, meta, _, _, path = artifacts[("int8", False)]
    assert set(os.listdir(path)) == {ARTIFACT_GRAPH, "meta.json"}
    assert meta == {
        "format_version": 1, "model": "bisenet", "context_path": "resnet18", "num_classes": 19,
        "precision": "int8", "quant_clip": CFG.quant_clip, "height": H, "width": W, "batch": None,
        "platforms": ["cpu"], "fused_conv3": False,
        "input": "uint8 NHWC RGB images, any size pre-resized to (height, width)",
        "output": "uint8 NHW trainId masks (argmax over classes)", "torch_version": torch.__version__,
    }
    assert artifacts[("bf16", True)][1]["fused_conv3"] is True
    assert artifacts[("bf16", False)][1]["quant_clip"] is None


def test_meta_keeps_every_jax_field(bridged):
    """Every field of JAX's meta.json, ``torch_version`` for
    ``jax_version``, plus ``fused_conv3``."""
    jcfg = jconfig.ModelConfig(compute_dtype="float32")
    jvars = jinit_model(jbuild_model(jcfg), jax.random.PRNGKey(0), (1, 16, 32, 3), train=False)
    _, jmeta = jserving.export_serving(jcfg, jconfig.AugmentConfig(), jvars, 16, 32, batch=2, precision="f32",
                                       platforms=("cpu",))
    _, meta = export_serving(ModelConfig(compute_dtype="float32"), AUG, bridged["variables"], 16, 32, batch=2,
                             precision="f32", device="cpu")
    assert set(meta) == (set(jmeta) - {"jax_version"}) | {"torch_version", "fused_conv3"}
    for key in set(jmeta) - {"jax_version", "platforms"}:
        assert meta[key] == jmeta[key], key


def test_pinned_batch_rejects_another_batch(bridged, tmp_path):
    exported, meta = export_serving(CFG, AUG, bridged["variables"], H, W, batch=2, device="cpu")
    assert meta["batch"] == 2
    save_artifact(str(tmp_path), exported, meta)
    fn, _ = load_artifact(str(tmp_path), device="cpu")
    eager = make_serving_fn(CFG, AUG, bridged["variables"], device="cpu")
    assert torch.equal(fn(bridged["frames"][:2]), eager(bridged["frames"][:2]))
    with pytest.raises(Exception, match="== 2"):  # the program's input guard
        fn(bridged["frames"])


def test_export_and_load_refusals(bridged, artifacts, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="calibrate"):
        export_serving(CFG, AUG, bridged["variables"], H, W, precision="int8", device="cpu")
    with pytest.raises(ValueError, match="batch must be positive"):
        export_serving(CFG, AUG, bridged["variables"], H, W, batch=0, device="cpu")
    with pytest.raises(ValueError, match="fused_conv3 serves bf16 only"):
        export_serving(CFG, AUG, bridged["calibrated"], H, W, precision="int8", fused_conv3=True, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_artifact(str(tmp_path / "missing"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_serving(CFG, AUG, bridged["variables"], H, W)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_artifact(artifacts[("bf16", False)][4], device="cuda")


def test_export_checks_the_int8_fold_eagerly(bridged, monkeypatch):
    """A frozen QuantConv whose ``wq`` changed after the fold raises before
    the trace, as its eager forward would."""
    from rtda_semanticsegmentation_tpu_torch import serving

    build = serving.serving_module

    def stale(*args, **kw):
        module = build(*args, **kw)
        conv = next(m for m in module.modules() if isinstance(m, QuantConv))
        with torch.no_grad():
            conv.wq.add_(0)
        return module

    monkeypatch.setattr(serving, "serving_module", stale)
    with pytest.raises(RuntimeError, match="wq changed"):
        serving.export_serving(CFG, AUG, bridged["calibrated"], H, W, precision="int8", device="cpu")


def test_load_artifact_needs_no_model_code(artifacts):
    """In a fresh process: load and serve the int8 artifact without importing
    the port's models (only torch and the kernels' op registration)."""
    path = artifacts[("int8", False)][4]
    code = (
        "import sys, numpy as np, torch\n"
        "from rtda_semanticsegmentation_tpu_torch.serving import load_artifact\n"
        f"fn, meta = load_artifact({path!r}, device='cpu')\n"
        f"masks = fn(np.zeros((2, {H}, {W}, 3), np.uint8))\n"
        f"assert tuple(masks.shape) == (2, {H}, {W}) and masks.dtype == torch.uint8\n"
        "bad = [m for m in sys.modules if m.startswith('rtda_semanticsegmentation_tpu_torch.models')\n"
        "       or m.split('.')[0] in ('jax', 'flax', 'rtda_semanticsegmentation_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# K3's op at the shapes the models give it: (kernel, stride, dilation, C, CO)
K3_CASES = [(3, 1, 1, 16, 24), (3, 2, 1, 16, 19), (1, 2, 1, 32, 16), (1, 1, 1, 16, 16),
            (3, 1, 2, 16, 24), (3, 2, 2, 16, 19), (3, 1, 4, 16, 24), (3, 2, 4, 32, 16)]


@pytest.mark.parametrize("k,s,d,c,co", K3_CASES)
def test_int8_conv_op_opcheck(k, s, d, c, co):
    rng = np.random.RandomState(100 * k + 10 * s + d)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 9, 11, c)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (k, k, c, co)).astype(np.int8))
    a = torch.from_numpy(rng.rand(co).astype(np.float32) * 1e-3)
    b = torch.from_numpy(rng.randn(co).astype(np.float32))
    inv = torch.from_numpy(rng.rand(co).astype(np.float32) + 0.5)
    wk, colsum = k3.kmajor_weights(wq)
    p = d if k == 3 else 0
    for args in ((xq, wq, a, b, None, None, None, s, p, d, False, torch.bfloat16),
                 (xq, wq, a, b, inv, wk, colsum, s, p, d, True, torch.bfloat16),
                 (xq, wq, a, b, None, wk, colsum, s, p, d, True, torch.float32)):
        torch.library.opcheck(k3.int8_conv_op, args)
        want = k3.int8_conv_plain(*args[:5], stride=s, padding=p, dilation=d, relu=args[10], out_dtype=args[11])
        assert torch.equal(k3.int8_conv_op(*args), want)


@pytest.mark.parametrize("d,epilogue", [(1, True), (1, False), (2, True), (4, True)])
def test_conv3x3_op_opcheck(d, epilogue):
    rng = np.random.RandomState(d + 10 * epilogue)
    x = torch.from_numpy(rng.randn(2, 9, 11, 16).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(3, 3, 16, 24).astype(np.float32) * 0.1).to(torch.bfloat16)
    scale = torch.from_numpy(rng.rand(19).astype(np.float32) + 0.5) if epilogue else None
    shift = torch.from_numpy(rng.randn(19).astype(np.float32)) if epilogue else None
    args = (x, w[..., :19], scale, shift, epilogue, d, torch.bfloat16)
    torch.library.opcheck(k4.conv3x3_op, args)
    got = k4.conv3x3_op(*args)
    assert got.is_contiguous()
    assert torch.equal(got, k4.conv3x3_plain(x, w[..., :19], scale, shift, relu=epilogue, dilation=d))


def _flags(parser):
    return {a.option_strings[0]: (a.dest, a.default, a.choices, a.nargs, a.type, a.required)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_export_cli_flags_are_jax_s():
    """JAX's flags, ``--platforms`` replaced by ``--device`` and
    ``--fused_conv3`` added."""
    from rtda_semanticsegmentation_tpu.cli import export as jexport
    from rtda_semanticsegmentation_tpu_torch.cli import export as texport

    port, ref = _flags(texport.build_parser()), _flags(jexport.build_parser())
    assert port.pop("--device") == ("device", "cuda", ("cuda", "cpu"), None, None, False)
    assert port.pop("--fused_conv3")[:2] == ("fused_conv3", False)
    ref.pop("--platforms")
    assert port == ref


def test_export_cli_int8_serves_predict_s_masks(tmp_path, monkeypatch):
    """``cli/export`` in int8 (symbolic batch, calibrated on the frames'
    first 2 batches of 2) then ``predict --artifact`` writes the PNGs of
    ``predict --precision int8`` calibrated on the same batches; without
    ``--calib_images`` the export refuses, and without a card it raises."""
    from PIL import Image

    from rtda_semanticsegmentation_tpu_torch.cli.export import main as export_main
    from rtda_semanticsegmentation_tpu_torch.cli.predict import main as predict_main

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.RandomState(2)
    for i in range(5):
        Image.fromarray(rng.randint(0, 256, (40, 72, 3), np.uint8)).save(frames / f"f{i}.png")
    size = ["--size", "32", "64", "--precision", "int8", "--device", "cpu"]
    assert export_main(["--output", str(tmp_path / "art"), *size]) == 2
    assert export_main(["--output", str(tmp_path / "art"), "--calib_images", str(frames), "--calib_batches", "2",
                        "--calib_batch_size", "2", *size]) == 0
    assert json.load(open(tmp_path / "art" / "meta.json"))["batch"] is None
    assert predict_main(["--images", str(frames), "--output", str(tmp_path / "a"), "--artifact",
                         str(tmp_path / "art"), "--batch_size", "3", "--device", "cpu"]) == 0
    assert predict_main(["--images", str(frames), "--output", str(tmp_path / "e"), "--batch_size", "2",
                         "--calib_batches", "2", *size]) == 0
    names = sorted(os.listdir(tmp_path / "e"))
    assert names == sorted(os.listdir(tmp_path / "a")) and len(names) == 10
    for name in names:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a" / name)),
                                      np.asarray(Image.open(tmp_path / "e" / name)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        export_main(["--output", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()
