"""The port's native host decode (``data/native.py`` on its copy of
``_native/fastdata.cpp``), the cases of the JAX package's
``tests/test_native_data.py``: bit-exact against PIL and equal to the JAX
package's native output on the same files. Needs ``g++``, ``png.h`` and
``jpeglib.h``; the library builds into ``build/native/`` on first use."""

import numpy as np
import pytest
from PIL import Image

from rtda_semanticsegmentation_tpu.data import native as jnative
from rtda_semanticsegmentation_tpu_torch.data import native
from rtda_semanticsegmentation_tpu_torch.data.datasets import GTA5Dataset
from rtda_semanticsegmentation_tpu_torch.data.labels import (
    IGNORE_INDEX,
    build_color_to_id_lut,
    rgb_label_to_train_ids,
)


@pytest.fixture()
def rng():
    return np.random.RandomState(0)


def test_library_builds_under_the_repository(monkeypatch):
    monkeypatch.delenv("RTDA_NATIVE_DECODE", raising=False)
    assert native.available(), native.unavailable_reason()
    assert native._build().startswith(str(native.BUILD_DIR))
    assert native.BUILD_DIR.parent.name == "build"


@pytest.mark.parametrize("in_size,out_size", [((40, 60), (24, 36)), ((24, 36), (48, 72)), ((33, 47), (70, 90)),
                                              ((64, 64), (64, 64))])
def test_image_bilinear_bit_exact_vs_pil_and_jax(tmp_path, rng, in_size, out_size):
    a = rng.randint(0, 256, in_size + (3,), np.uint8)
    p = str(tmp_path / "img.png")
    Image.fromarray(a).save(p)
    out = native.load_image(p, out_size)
    np.testing.assert_array_equal(out, np.asarray(Image.fromarray(a).resize(out_size[::-1], Image.BILINEAR)))
    np.testing.assert_array_equal(out, jnative.load_image(p, out_size))


def test_jpeg_decode_matches_pil(tmp_path, rng):
    p = str(tmp_path / "img.jpg")
    Image.fromarray(rng.randint(0, 256, (40, 56, 3), np.uint8)).save(p, quality=90)
    out = native.load_image(p, (40, 56))
    np.testing.assert_array_equal(out, np.asarray(Image.open(p).convert("RGB")))
    np.testing.assert_array_equal(out, jnative.load_image(p, (40, 56)))


def test_gray_label_nearest_exact(tmp_path, rng):
    lab = rng.randint(0, 19, (41, 61), np.uint8)
    lab[0, :] = IGNORE_INDEX
    p = str(tmp_path / "lab.png")
    Image.fromarray(lab, mode="L").save(p)
    out = native.load_label(p, (25, 33))
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, np.asarray(Image.fromarray(lab).resize((33, 25), Image.NEAREST)))
    np.testing.assert_array_equal(out, jnative.load_label(p, (25, 33)))


def test_palette_label_returns_raw_indices(tmp_path):
    lab = np.tile(np.arange(16, dtype=np.uint8), (8, 1))
    im = Image.fromarray(lab, mode="P")
    im.putpalette([v for i in range(256) for v in (i, 0, 255 - i)])
    p = str(tmp_path / "pal.png")
    im.save(p)
    np.testing.assert_array_equal(native.load_label(p, (8, 16)), lab)


def test_rgb_label_lut_matches_python(tmp_path):
    rgb = np.zeros((20, 30, 3), np.uint8)
    rgb[:10] = [128, 64, 128]  # road -> 0
    rgb[10:] = [107, 142, 35]  # vegetation -> 8
    rgb[:, 0] = [1, 2, 3]  # unknown colour -> ignore
    p = str(tmp_path / "rgb.png")
    Image.fromarray(rgb).save(p)
    out = native.load_label(p, (20, 30), rgb_lut=build_color_to_id_lut())
    np.testing.assert_array_equal(out, rgb_label_to_train_ids(rgb))


def test_refusals(tmp_path, rng):
    """An RGB label without a LUT, a missing file, a 16-bit label and a LUT
    of the wrong size."""
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "x.png")
    with pytest.raises(OSError, match="LUT"):
        native.load_label(str(tmp_path / "x.png"), (4, 4))
    with pytest.raises(OSError, match="open"):
        native.load_image("/nonexistent/file.png", (4, 4))
    p16 = str(tmp_path / "lab16.png")
    Image.fromarray(rng.randint(0, 19, (9, 11)).astype(np.uint16)).save(p16)
    with pytest.raises(OSError, match="unsupported"):
        native.load_label(p16, (9, 11))
    with pytest.raises(ValueError, match="256"):
        native.load_label(str(tmp_path / "x.png"), (4, 4), rgb_lut=np.zeros(10, np.uint8))


def test_rgba_input_drops_alpha(tmp_path, rng):
    rgba = rng.randint(0, 256, (12, 14, 4), np.uint8)
    rgba[..., 3] = 255
    p = str(tmp_path / "rgba.png")
    Image.fromarray(rgba, mode="RGBA").save(p)
    np.testing.assert_array_equal(native.load_image(p, (12, 14)), rgba[..., :3])


def test_palette_colour_label_maps_through_lut(tmp_path):
    """Palette-encoded colour labels (the GTA5 encoding) map by palette
    colour, never by raw index."""
    idx = np.zeros((10, 12), np.uint8)
    idx[5:] = 1
    im = Image.fromarray(idx, mode="P")
    pal = [0] * 768
    pal[0:3] = [128, 64, 128]
    pal[3:6] = [70, 130, 180]
    im.putpalette(pal)
    p = str(tmp_path / "pal_color.png")
    im.save(p)
    out = native.load_label(p, (10, 12), rgb_lut=build_color_to_id_lut())
    np.testing.assert_array_equal(out, np.where(idx == 0, 0, 10))
    np.testing.assert_array_equal(out, rgb_label_to_train_ids(np.asarray(Image.open(p).convert("RGB"))))


def _gta_tree(root, rng, n=2, hw=(50, 70), rgb_labels=False, label_dtype=np.uint8):
    (root / "images").mkdir(parents=True)
    sub = "labels" if rgb_labels else "labels_trainids"
    (root / sub).mkdir()
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, hw + (3,), np.uint8)).save(root / "images" / f"{i:05d}.png")
        if rgb_labels:
            rgb = np.zeros(hw + (3,), np.uint8)
            rgb[: hw[0] // 2] = [128, 64, 128]
            rgb[hw[0] // 2:] = [70, 130, 180]
            Image.fromarray(rgb).save(root / sub / f"{i:05d}.png")
        else:
            Image.fromarray(rng.randint(0, 19, hw).astype(label_dtype)).save(root / sub / f"{i:05d}.png")


@pytest.mark.parametrize("labels", ["trainids", "rgb", "16-bit"])
def test_dataset_native_equals_pil(tmp_path, rng, labels):
    """GTA5Dataset with native_decode 'on' equals 'off', bit for bit: grey
    trainId labels, RGB labels converted on the fly, and 16-bit labels,
    which the native path refuses and PIL reads verbatim."""
    root = tmp_path / "gta"
    _gta_tree(root, rng, rgb_labels=labels == "rgb", label_dtype=np.uint16 if labels == "16-bit" else np.uint8)
    kw = dict(labels_subdir="labels", convert_on_the_fly=True) if labels == "rgb" else {}
    on = GTA5Dataset(str(root), size=(32, 48), native_decode="on", **kw)
    off = GTA5Dataset(str(root), size=(32, 48), native_decode="off", **kw)
    for i in range(len(on)):
        for a, b in zip(on.load(i), off.load(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
