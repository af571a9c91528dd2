"""The port's data layer against the JAX package's: every comparison is
exact (the same uint8 / int32 bits), since both sides run the same numpy
and PIL code on the same files and seeds."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu.data import datasets as jdatasets
from rtda_semanticsegmentation_tpu.data import labels as jlabels
from rtda_semanticsegmentation_tpu.data import loader as jloader
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.data import datasets as tdatasets
from rtda_semanticsegmentation_tpu_torch.data import labels as tlabels
from rtda_semanticsegmentation_tpu_torch.data import loader as tloader

from test_torch_loop import drop_tmp_path, torch_one_thread  # noqa: E402,F401  (autouse fixtures)


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture()
def roots(tmp_path):
    """A tiny Cityscapes tree (val 3, train 2) and a GTA5 tree with RGB
    colour labels and their trainId conversions."""
    rng = np.random.RandomState(0)
    cs = tmp_path / "cs"
    for split, n in (("val", 3), ("train", 2)):
        for i in range(n):
            stem = f"city_{i:06d}_000019"
            _png(str(cs / "images" / split / "city" / f"{stem}_leftImg8bit.png"),
                 rng.randint(0, 256, (40, 56, 3), np.uint8))
            _png(str(cs / "gtFine" / split / "city" / f"{stem}_gtFine_labelTrainIds.png"),
                 rng.choice([0, 1, 5, 18, 255], (40, 56)).astype(np.uint8))
    gta = tmp_path / "gta"
    colors = np.array(jlabels.GTA5_CLASS_COLORS + ((1, 2, 3),), np.uint8)
    for i in range(3):
        _png(str(gta / "images" / f"{i:05d}.png"), rng.randint(0, 256, (40, 56, 3), np.uint8))
        _png(str(gta / "labels" / f"{i:05d}.png"), colors[rng.randint(0, len(colors), (40, 56))])
    return str(cs), str(gta)


def test_synthetic_dataset_same_bits_as_jax():
    for seed, size, classes in ((0, (32, 48), 19), (3, (17, 9), 19), (1, (8, 8), 2)):
        port = tdatasets.SyntheticDataset(length=5, size=size, num_classes=classes, seed=seed)
        ref = jdatasets.SyntheticDataset(length=5, size=size, num_classes=classes, seed=seed)
        assert len(port) == len(ref) == 5
        for i in range(5):
            (pi, pl), (ri, rl) = port.load(i), ref.load(i)
            assert pi.dtype == ri.dtype == np.uint8 and pl.dtype == rl.dtype
            np.testing.assert_array_equal(pi, ri)
            np.testing.assert_array_equal(pl, rl)


def test_file_datasets_decode_as_jax(roots):
    cs, gta = roots
    pairs = [
        (tdatasets.CityscapesDataset(cs, "val", (32, 64)), jdatasets.CityscapesDataset(cs, "val", (32, 64),
                                                                                        native_decode="off")),
        (tdatasets.GTA5Dataset(gta, "labels", True, (24, 40)), jdatasets.GTA5Dataset(gta, "labels", True, (24, 40),
                                                                                      native_decode="off")),
    ]
    for port, ref in pairs:
        assert port.pairs == ref.pairs and len(port) == 3
        for i in range(3):
            for a, b in zip(port.load(i), ref.load(i)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_build_dataset_and_unported_decoders(roots):
    cs, _ = roots
    cfg = tconfig.DataConfig(cityscapes_path=cs, synthetic_length=7)
    assert isinstance(tdatasets.build_dataset("cityscapes", "train", (16, 16), cfg), tdatasets.CityscapesDataset)
    assert len(tdatasets.build_dataset("synthetic", "val", (16, 16), cfg)) == 7
    with pytest.raises(ValueError, match="unknown dataset"):
        tdatasets.build_dataset("kitti", "val", (16, 16), cfg)
    # native_decode='on' decodes (the same bits as PIL), or raises only with
    # the library build's reason
    from rtda_semanticsegmentation_tpu_torch.data import native

    on = tdatasets.build_dataset("cityscapes", "val", (16, 16), tconfig.DataConfig(cityscapes_path=cs,
                                                                                    native_decode="on"))
    off = tdatasets.build_dataset("cityscapes", "val", (16, 16), tconfig.DataConfig(cityscapes_path=cs,
                                                                                     native_decode="off"))
    if native.available():
        for a, b in zip(on.load(0), off.load(0)):
            np.testing.assert_array_equal(a, b)
    else:
        with pytest.raises(RuntimeError, match="native_decode='on' but the fast path is unavailable"):
            on.load(0)
    # decoded_cache_dir builds the cache around a file dataset, not around
    # generated frames
    from rtda_semanticsegmentation_tpu_torch.data.cache import DecodedCacheDataset

    cached = tdatasets.build_dataset("cityscapes", "val", (16, 16), tconfig.DataConfig(
        cityscapes_path=cs, decoded_cache_dir=os.path.join(os.path.dirname(cs), "cache")))
    assert isinstance(cached, DecodedCacheDataset)
    for a, b in zip(cached.load(1), off.load(1)):
        np.testing.assert_array_equal(a, b)
    assert os.path.exists(cached._entry_path(1))
    assert isinstance(tdatasets.build_dataset("synthetic", "val", (16, 16), tconfig.DataConfig(
        decoded_cache_dir=os.path.join(os.path.dirname(cs), "cache"))), tdatasets.SyntheticDataset)
    assert tconfig.DataConfig(num_workers=0).resolved_num_workers() == 1
    assert (tconfig.DataConfig().resolved_num_workers() == jconfig.DataConfig().resolved_num_workers())


def _images(batches):
    return [b["image"].copy() for b in batches]


@pytest.mark.parametrize("num_workers", [1, 3])
def test_loader_batches_bit_identical_to_jax(num_workers):
    """Across epochs, after set_epoch, and from iter_from(k)."""
    ds_t = tdatasets.SyntheticDataset(length=14, size=(8, 12))
    ds_j = jdatasets.SyntheticDataset(length=14, size=(8, 12))
    for shuffle, drop_last in ((True, True), (False, False)):
        port = tloader.Loader(ds_t, 4, shuffle=shuffle, drop_last=drop_last, seed=9, num_workers=num_workers)
        ref = jloader.Loader(ds_j, 4, shuffle=shuffle, drop_last=drop_last, seed=9, num_workers=num_workers)
        assert len(port) == len(ref)
        for _ in range(3):  # three epochs, each reshuffled
            a, b = list(port), list(ref)
            assert len(a) == len(b)
            for x, y in zip(a, b):
                for k in ("image", "label"):
                    np.testing.assert_array_equal(x[k], y[k])
        port.set_epoch(7)
        ref.set_epoch(7)
        for x, y in zip(port.iter_from(1), ref.iter_from(1)):
            np.testing.assert_array_equal(x["image"], y["image"])
        assert port.epoch == ref.epoch == 8


def test_infinite_loader_and_set_position_match_jax():
    ds_t = tdatasets.SyntheticDataset(length=12, size=(8, 8))
    ds_j = jdatasets.SyntheticDataset(length=12, size=(8, 8))

    def pair():
        return (tloader.InfiniteLoader(tloader.Loader(ds_t, 4, seed=5)),
                jloader.InfiniteLoader(jloader.Loader(ds_j, 4, seed=5)))

    port, ref = pair()
    stream = [next(ref)["image"].copy() for _ in range(8)]  # 3 batches a pass
    np.testing.assert_array_equal(np.stack(_images(next(port) for _ in range(8))), np.stack(stream))
    for k in (0, 2, 3, 5, 7):
        port, _ = pair()
        port.set_position(k)
        for j in range(k, 8):
            np.testing.assert_array_equal(next(port)["image"], stream[j], err_msg=f"batch {j} after {k}")
    with pytest.raises(ValueError, match="target stream is empty"):
        tloader.InfiniteLoader(tloader.Loader(tdatasets.SyntheticDataset(length=2, size=(8, 8)), 4))


def test_zip_source_target_pairs_as_jax():
    ds_t, ds_j = (m.SyntheticDataset(length=8, size=(8, 8), seed=s) for m, s in ((tdatasets, 1), (jdatasets, 1)))
    tgt_t, tgt_j = (m.SyntheticDataset(length=4, size=(8, 8), seed=2) for m in (tdatasets, jdatasets))
    port = list(tloader.zip_source_target(iter(tloader.Loader(ds_t, 2, seed=1)),
                                          tloader.InfiniteLoader(tloader.Loader(tgt_t, 2, seed=2))))
    ref = list(jloader.zip_source_target(iter(jloader.Loader(ds_j, 2, seed=1)),
                                         jloader.InfiniteLoader(jloader.Loader(tgt_j, 2, seed=2))))
    assert len(port) == len(ref) == 4
    for x, y in zip(port, ref):
        assert x.keys() == y.keys() == {"image", "label", "target_image"}
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("process_count", [1, 2])
def test_eval_batches_pad_as_jax(roots, process_count):
    cs, _ = roots
    port_ds = tdatasets.CityscapesDataset(cs, "val", (16, 32))
    ref_ds = jdatasets.CityscapesDataset(cs, "val", (16, 32), native_decode="off")
    for bs in (2, 4):
        for pi in range(process_count):
            port = list(tloader.eval_batches(port_ds, bs, 2, pi, process_count))
            ref = list(jloader.eval_batches(ref_ds, bs, 2, pi, process_count))
            assert len(port) == len(ref)
            for x, y in zip(port, ref):
                for a, b in zip(x, y):
                    assert a.dtype == b.dtype and a.shape == b.shape
                    np.testing.assert_array_equal(a, b)
    imgs, labels, valid = list(tloader.eval_batches(port_ds, 2))[-1]
    assert valid.tolist() == [True, False] and not imgs[1].any() and not labels[1].any()


def test_prefetch_to_device_on_cpu_keeps_every_batch():
    """On the CPU the batches become tensors without a copy; a depth <= 0
    still yields every batch (one in flight)."""
    ds = tdatasets.SyntheticDataset(length=8, size=(8, 8))
    want = list(tloader.Loader(ds, 4, shuffle=False))
    for depth in (0, -1, 1, 3):
        got = list(tloader.prefetch_to_device(iter(tloader.Loader(ds, 4, shuffle=False)), "cpu", depth))
        assert len(got) == 2, depth
        for g, w in zip(got, want):
            assert isinstance(g["image"], torch.Tensor) and g["label"].dtype == torch.int32
            np.testing.assert_array_equal(g["image"].numpy(), w["image"])
    tup = list(tloader.prefetch_to_device(tloader.lookahead(tloader.eval_batches(ds, 3), 2), "cpu", 2))
    assert [t[2].tolist() for t in tup] == [[True] * 3, [True] * 3, [True, True, False]]


def test_labels_match_jax():
    rng = np.random.RandomState(0)
    colors = np.array(jlabels.GTA5_CLASS_COLORS + ((1, 2, 3), (0, 0, 0)), np.uint8)
    rgb = colors[rng.randint(0, len(colors), (24, 32))]
    np.testing.assert_array_equal(tlabels.rgb_label_to_train_ids(rgb), jlabels.rgb_label_to_train_ids(rgb))
    np.testing.assert_array_equal(tlabels.build_color_to_id_lut(), jlabels.build_color_to_id_lut())
    assert tlabels.CITYSCAPES_ID_TO_NAME == jlabels.CITYSCAPES_ID_TO_NAME
    assert tlabels.TRAINID_COLORS == jlabels.CITYSCAPES_TRAINID_COLORS
    with pytest.raises(ValueError, match="RGB"):
        tlabels.rgb_label_to_train_ids(rgb[..., 0])
