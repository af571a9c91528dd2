"""Decoded-sample disk cache: decode each PNG once, then read raw bytes
(the port's copy of the JAX package's ``data/cache.py``).

Full-resolution PNG inflate dominates the host data path, and PNG has no
reduced-scale decode, so on a decode-bound host the device starves. This
cache stores each sample's post-decode, post-resize tensors (uint8 HWC
image + int32 HW trainId label) as one raw ``.bin`` per sample: epoch 1
populates it through the normal decode path, every later epoch (and every
later run pointed at the same directory) reads the raw bytes instead of
inflating a PNG.

Correctness properties:

- The cache directory is keyed by a fingerprint of the dataset identity
  (class, resize target, label mode, and the full ordered pair list with
  each file's size + mtime), so different datasets/splits/sizes never
  collide and re-generated source files (e.g. re-run label preprocessing)
  get a fresh key instead of being served stale. Only an edit that
  preserves a file's path, byte length, AND mtime goes undetected.
- A read-only or full cache disk degrades to the plain decode path
  (reads still hit a pre-built cache; writes are best-effort) — the cache
  is an accelerator, never a requirement.
- Writes are atomic (temp file + ``os.replace``): a crash mid-write leaves
  no corrupt entry, and concurrent loader threads writing the same index
  are safe.
- A corrupt/truncated/foreign entry fails validation (magic + shape +
  exact byte length) and falls back to the decode path, which rewrites it.

No eviction: entries are immutable function outputs of the fingerprinted
inputs. Delete the directory to reclaim space (GTA5 at 1280x720 is
6.5 MB/sample, about 162 GB for all 24966 frames; Cityscapes-train at
1024x512 about 10 GB).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Tuple

import numpy as np

from .datasets import SegmentationDataset

_MAGIC = b"RTDC1\n"
_HEADER = struct.Struct("<6sII")  # magic, H, W


def _fingerprint(base: SegmentationDataset) -> str:
    h = hashlib.sha1()
    h.update(type(base).__name__.encode())
    h.update(repr(tuple(base.size)).encode())
    h.update(repr(getattr(base, "convert_on_the_fly", None)).encode())
    for img_p, lab_p in base.pairs:
        for p in (img_p, lab_p):
            h.update(p.encode())
            # Size + mtime: re-generated/replaced source files change the
            # key (served fresh) instead of being served stale.
            try:
                st = os.stat(p)
                h.update(struct.pack("<qq", st.st_size, st.st_mtime_ns))
            except OSError:
                h.update(b"?")
    hh, ww = base.size
    return f"{type(base).__name__.lower()}_{hh}x{ww}_{h.hexdigest()[:16]}"


class DecodedCacheDataset(SegmentationDataset):
    """Wrap any :class:`SegmentationDataset` with a decoded-sample cache.

    Duck-compatible with the base dataset (``pairs``/``size``/``load``);
    built by :func:`~rtda_semanticsegmentation_tpu_torch.data.datasets.build_dataset`
    when ``data.decoded_cache_dir`` is set.
    """

    def __init__(self, base: SegmentationDataset, cache_dir: str):
        self.base = base
        self.pairs = base.pairs
        self.size = tuple(base.size)
        self.native_decode = getattr(base, "native_decode", "auto")
        self.dir = os.path.join(
            os.path.abspath(cache_dir), _fingerprint(base)
        )
        # Accelerator, not a requirement: an uncreatable cache directory
        # (read-only mount, full disk) degrades to the plain decode path —
        # but reads from an existing pre-built directory still work.
        self._writable = True
        try:
            os.makedirs(self.dir, exist_ok=True)
        except OSError as e:
            if not os.path.isdir(self.dir):
                import warnings

                warnings.warn(
                    f"decoded cache disabled: cannot create {self.dir} ({e})"
                )
            self._writable = False
        meta_path = os.path.join(self.dir, "meta.json")
        if self._writable and not os.path.exists(meta_path):
            tmp = meta_path + f".tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump(
                        {
                            "dataset": type(base).__name__,
                            "size": list(self.size),
                            "num_samples": len(base),
                            "first_pair": (
                                list(base.pairs[0]) if base.pairs else []
                            ),
                        },
                        f,
                        indent=1,
                    )
                os.replace(tmp, meta_path)
            except OSError:
                # meta.json is informational; a read-only pre-built cache
                # without one still serves entries.
                self._writable = False

    def __len__(self) -> int:
        return len(self.base)

    # -- raw record format ---------------------------------------------------

    def _entry_path(self, index: int) -> str:
        return os.path.join(self.dir, f"{index:07d}.bin")

    def _try_read(self, path: str):
        hh, ww = self.size
        img_bytes = hh * ww * 3
        lab_bytes = hh * ww * 4
        expected = _HEADER.size + img_bytes + lab_bytes
        try:
            with open(path, "rb") as f:
                buf = f.read(expected + 1)
        except OSError:
            return None
        if len(buf) != expected:
            return None
        magic, h, w = _HEADER.unpack_from(buf)
        if magic != _MAGIC or (h, w) != (hh, ww):
            return None
        off = _HEADER.size
        img = (
            np.frombuffer(buf, np.uint8, img_bytes, off)
            .reshape(hh, ww, 3)
            .copy()
        )
        label = (
            np.frombuffer(buf, "<i4", hh * ww, off + img_bytes)
            .reshape(hh, ww)
            .copy()
        )
        return img, label

    def _write(self, path: str, img: np.ndarray, label: np.ndarray) -> None:
        hh, ww = self.size
        # Unique per process AND thread: two loader threads can decode the
        # same not-yet-cached index concurrently (e.g. an abandoned epoch's
        # pending prefetch racing the next epoch); sharing one tmp name
        # would interleave their writes and let a reader observe a
        # hole-filled entry of the right length mid-publish.
        import threading

        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(_HEADER.pack(_MAGIC, hh, ww))
                f.write(np.ascontiguousarray(img, np.uint8).tobytes())
                f.write(
                    np.ascontiguousarray(label, np.int32)
                    .astype("<i4", copy=False)
                    .tobytes()
                )
            os.replace(tmp, path)
        except OSError:
            # Cache is an accelerator, not a requirement: a full/read-only
            # disk must not kill training.
            try:
                os.remove(tmp)
            except OSError:
                pass

    # -- dataset API ---------------------------------------------------------

    def load(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        path = self._entry_path(index)
        cached = self._try_read(path)
        if cached is not None:
            return cached
        img, label = self.base.load(index)
        if self._writable:
            self._write(path, img, label)
        return img, label


def main(argv=None) -> None:
    """Prewarm CLI: populate the cache with every host thread before
    training, instead of paying the decode inside epoch 1::

        python -m rtda_semanticsegmentation_tpu_torch.data.cache \\
            --dataset gta5 --split train --gta5_path ... --cache_dir ...
    """
    import argparse
    import time
    from concurrent.futures import ThreadPoolExecutor

    from ..config import DataConfig
    from .datasets import build_dataset

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--dataset", choices=("gta5", "cityscapes"), required=True)
    p.add_argument("--split", default="train",
                   help="cityscapes split (gta5 has a single split)")
    p.add_argument("--gta5_path", default=DataConfig.gta5_path)
    p.add_argument("--cityscapes_path", default=DataConfig.cityscapes_path)
    p.add_argument("--size", type=int, nargs=2, metavar=("H", "W"),
                   default=None,
                   help="resize target (defaults: GTA5 720 1280, "
                        "Cityscapes 512 1024 — the training sizes)")
    p.add_argument("--cache_dir", required=True)
    p.add_argument("--num_workers", type=int, default=-1,
                   help="-1 = min(32, cpu_count)")
    args = p.parse_args(argv)

    import dataclasses

    dcfg = DataConfig()
    dcfg = dataclasses.replace(
        dcfg,
        gta5_path=args.gta5_path,
        cityscapes_path=args.cityscapes_path,
        decoded_cache_dir=args.cache_dir,
        num_workers=args.num_workers,
    )
    size = tuple(args.size) if args.size else (
        dcfg.gta5_size if args.dataset == "gta5" else dcfg.cityscapes_size
    )
    ds = build_dataset(args.dataset, args.split, size, dcfg)
    n, workers = len(ds), dcfg.resolved_num_workers()
    print(f"prewarming {n} samples at {size} into {ds.dir} "
          f"({workers} threads)")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers) as pool:
        for i, _ in enumerate(pool.map(ds.load, range(n)), 1):
            if i % 200 == 0 or i == n:
                dt = time.perf_counter() - t0
                print(f"  {i}/{n} ({i / dt:.1f} samples/s)", flush=True)
    print(f"done in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
