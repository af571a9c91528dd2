"""The port's host data tools against the JAX package's: the decoded-sample
cache (``data/cache.py``), GTA5 label preprocessing (``data/preprocess.py``)
and the dataset panel (``cli/debug_dataset.py``). Every comparison is exact:
the same bytes and the same arrays."""

import os
import time

import numpy as np
import pytest
from PIL import Image

from rtda_semanticsegmentation_tpu.cli import debug_dataset as jdebug
from rtda_semanticsegmentation_tpu.data import cache as jcache
from rtda_semanticsegmentation_tpu.data import datasets as jdatasets
from rtda_semanticsegmentation_tpu.data import labels as jlabels
from rtda_semanticsegmentation_tpu.data import preprocess as jpreprocess
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.cli import debug_dataset as tdebug
from rtda_semanticsegmentation_tpu_torch.data import cache as tcache
from rtda_semanticsegmentation_tpu_torch.data import datasets as tdatasets
from rtda_semanticsegmentation_tpu_torch.data import loader as tloader
from rtda_semanticsegmentation_tpu_torch.data import preprocess as tpreprocess

H0, W0 = 40, 56


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture()
def cs_root(tmp_path):
    root = tmp_path / "cs"
    rng = np.random.RandomState(0)
    for i in range(3):
        stem = f"frankfurt_{i:06d}_000019"
        _png(str(root / "images" / "val" / "frankfurt" / f"{stem}_leftImg8bit.png"),
             rng.randint(0, 256, (H0, W0, 3), np.uint8))
        lab = rng.randint(0, 19, (H0, W0)).astype(np.uint8)
        lab[0, :] = 255
        _png(str(root / "gtFine" / "val" / "frankfurt" / f"{stem}_gtFine_labelTrainIds.png"), lab)
    return str(root)


@pytest.fixture()
def gta_root(tmp_path):
    root = tmp_path / "gta5"
    rng = np.random.RandomState(1)
    colors = np.asarray(jlabels.GTA5_CLASS_COLORS, np.uint8)
    for i in range(4):
        _png(str(root / "images" / f"{i:05d}.png"), rng.randint(0, 256, (H0, W0, 3), np.uint8))
        rgb = colors[rng.randint(0, 19, (H0, W0))]
        rgb[0, 0] = (1, 2, 3)  # an unknown colour -> ignore
        _png(str(root / "labels" / f"{i:05d}.png"), rgb)
    return str(root)


def _cached(root, cache_dir, size=(32, 64), native_decode="off"):
    base = tdatasets.CityscapesDataset(root, "val", size, native_decode=native_decode)
    return base, tcache.DecodedCacheDataset(base, str(cache_dir))


@pytest.mark.parametrize("native_decode", ["off", "on"])
def test_cache_samples_equal_jax_cache_and_the_decode(cs_root, tmp_path, native_decode):
    """Cold (decode and write) and warm (read) samples equal the decode path
    and JAX's ``DecodedCacheDataset``; the fingerprint and the entries'
    bytes are JAX's."""
    base, cached = _cached(cs_root, tmp_path / "port", native_decode=native_decode)
    ref = jcache.DecodedCacheDataset(jdatasets.CityscapesDataset(cs_root, "val", (32, 64), native_decode="off"),
                                     str(tmp_path / "jax"))
    assert os.path.basename(cached.dir) == os.path.basename(ref.dir)
    assert tcache._fingerprint(base) == jcache._fingerprint(ref.base)
    for _ in ("cold", "warm"):
        for i in range(len(base)):
            want = base.load(i)
            for got in (cached.load(i), ref.load(i)):
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
    for i in range(len(base)):
        with open(cached._entry_path(i), "rb") as f, open(ref._entry_path(i), "rb") as g:
            assert f.read() == g.read()
    assert os.path.exists(os.path.join(cached.dir, "meta.json"))


def test_cache_warm_read_serves_the_entry_not_the_source(cs_root, tmp_path):
    base, cached = _cached(cs_root, tmp_path / "cache")
    img0, lab0 = cached.load(0)
    Image.fromarray(np.zeros((H0, W0, 3), np.uint8)).save(base.pairs[0][0])
    img1, lab1 = cached.load(0)
    np.testing.assert_array_equal(img1, img0)
    np.testing.assert_array_equal(lab1, lab0)
    assert base.load(0)[0].max() == 0


def test_cache_corrupt_entry_is_rewritten(cs_root, tmp_path):
    _, cached = _cached(cs_root, tmp_path / "cache")
    img0, lab0 = cached.load(1)
    path = cached._entry_path(1)
    with open(path, "wb") as f:
        f.write(b"garbage")
    assert cached._try_read(path) is None
    img1, lab1 = cached.load(1)
    np.testing.assert_array_equal(img1, img0)
    np.testing.assert_array_equal(lab1, lab0)
    assert cached._try_read(path) is not None


def test_cache_changed_mtime_changes_the_fingerprint(cs_root, tmp_path):
    base, c1 = _cached(cs_root, tmp_path / "cache")
    c1.load(0)
    img_path = base.pairs[0][0]
    st = os.stat(img_path)
    os.utime(img_path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    _, c2 = _cached(cs_root, tmp_path / "cache")
    assert c2.dir != c1.dir
    _, c3 = _cached(cs_root, tmp_path / "cache", size=(16, 32))
    assert c3.dir not in (c1.dir, c2.dir)


def test_build_dataset_wraps_file_datasets_and_the_loader_reads_them(cs_root, tmp_path):
    cfg = tconfig.DataConfig(cityscapes_path=cs_root, decoded_cache_dir=str(tmp_path / "cache"))
    ds = tdatasets.build_dataset("cityscapes", "val", (32, 64), cfg)
    assert isinstance(ds, tcache.DecodedCacheDataset)
    assert not isinstance(tdatasets.build_dataset("synthetic", "val", (32, 64), cfg), tcache.DecodedCacheDataset)
    batches = list(tloader.Loader(ds, 2, shuffle=False, drop_last=False, seed=0, num_workers=2))
    assert sum(b["image"].shape[0] for b in batches) == 3
    assert len(os.listdir(ds.dir)) == 3 + 1  # the entries and meta.json


def test_cache_prewarm_cli(cs_root, tmp_path, capsys):
    tcache.main(["--dataset", "cityscapes", "--split", "val", "--cityscapes_path", cs_root, "--size", "32", "64",
                 "--cache_dir", str(tmp_path / "cache"), "--num_workers", "2"])
    out = capsys.readouterr().out
    assert "prewarming 3 samples" in out and "done in" in out
    (entry_dir,) = os.listdir(tmp_path / "cache")
    assert sorted(f for f in os.listdir(tmp_path / "cache" / entry_dir) if f.endswith(".bin")) == [
        f"{i:07d}.bin" for i in range(3)]


def test_preprocess_labels_writes_the_jax_bytes(gta_root, tmp_path, capsys):
    assert tpreprocess.preprocess_labels(gta_root, output_subdir="port", workers=2) == 4
    assert jpreprocess.preprocess_labels(gta_root, output_subdir="jax", workers=2) == 4
    for f in sorted(os.listdir(os.path.join(gta_root, "labels"))):
        with open(os.path.join(gta_root, "port", f), "rb") as a, open(os.path.join(gta_root, "jax", f), "rb") as b:
            assert a.read() == b.read()
        assert Image.open(os.path.join(gta_root, "port", f)).mode == "L"
    # already converted files are skipped, --overwrite rewrites them
    assert tpreprocess.preprocess_labels(gta_root, output_subdir="port") == 0
    time.sleep(0.01)
    tpreprocess.main(["--gta5_root", gta_root, "--output_subdir", "port", "--overwrite"])
    assert "converted 4/4" in capsys.readouterr().out
    # the converted labels load as the on-the-fly conversion does
    pre = tdatasets.GTA5Dataset(gta_root, "port", False, (24, 40), native_decode="off")
    fly = tdatasets.GTA5Dataset(gta_root, "labels", True, (24, 40), native_decode="off")
    for i in range(4):
        np.testing.assert_array_equal(pre.load(i)[1], fly.load(i)[1])
    with pytest.raises(SystemExit):
        tpreprocess.main(["--gta5_root", str(tmp_path / "missing")])


@pytest.mark.parametrize("dataset", ["gta5", "synthetic"])
def test_debug_dataset_panel_equals_jax(gta_root, tmp_path, dataset):
    tpreprocess.preprocess_labels(gta_root)
    args = ["--dataset", dataset, "--gta5_path", gta_root, "--index", "1", "--height", "32", "--width", "48"]
    tdebug.main(args + ["--output", str(tmp_path / "port.png")])
    jdebug.main(args + ["--output", str(tmp_path / "jax.png")])
    port, ref = np.asarray(Image.open(tmp_path / "port.png")), np.asarray(Image.open(tmp_path / "jax.png"))
    assert port.shape == (32, 3 * 48, 3)
    np.testing.assert_array_equal(port, ref)
