"""Host-side batch loading: threaded decode, seeded shuffling, the copy to
the device (the port's copy of the JAX package's ``data/loader.py``).

- ``Loader``: an epoch iterator of uint8 NHWC image / int32 NHW label
  batches (numpy), shuffled by ``RandomState(seed + epoch)``, ``drop_last``
  for training, decoded on a thread pool with the next batch decoded on its
  own thread while the current one is consumed. Its batches are the JAX
  package's, bit for bit.
- ``InfiniteLoader``: re-iterates with a fresh shuffle when exhausted (the
  adversarial target stream).
- ``prefetch_to_device``: keeps ``depth`` batches in flight to the device:
  pinned host memory, an asynchronous copy on a side CUDA stream, an event
  the consumer's stream waits on.
- ``eval_batches``: eval batches in order, the tail padded, with a per-image
  validity mask.

``process_index`` / ``process_count`` slice each global batch per process,
as in the JAX package; the port runs one process, so they are 0 / 1.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .datasets import SegmentationDataset


class Loader:
    """Iterable over epochs of ``{"image", "label"}`` numpy batches."""

    def __init__(self, dataset: SegmentationDataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 42, num_workers: int = 8,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0  # advanced by each pass; set_epoch() re-syncs on resume
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by {process_count} processes")
        if not drop_last and process_count > 1:
            raise ValueError("drop_last=False is not supported multi-host; use "
                             "eval_batches (padded static-shape tails) instead")
        self._pool: Optional[ThreadPoolExecutor] = None
        self._prefetcher: Optional[ThreadPoolExecutor] = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    @property
    def steps_per_epoch(self) -> int:
        return len(self)

    def set_epoch(self, epoch: int) -> None:
        """Re-sync the shuffle sequence after a resume: the next pass draws
        the permutation of ``seed + epoch``."""
        self.epoch = int(epoch)

    def _order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + epoch).permutation(n)
        return np.arange(n)

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers, thread_name_prefix="decode")
            # the batch prefetch has its own thread: a batch task submitted
            # into the decode pool would wait on that pool at num_workers=1
            self._prefetcher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="batch-prefetch")
        return self._pool

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[dict]:
        """One pass starting at batch ``start_batch``; the skipped batches are
        never decoded. Advances the epoch counter as ``__iter__`` does."""
        order = self._order(self.epoch)
        self.epoch += 1
        bs = self.batch_size
        n_batches = len(order) // bs if self.drop_last else -(-len(order) // bs)
        pool = self._ensure_pool()
        per_proc = bs // self.process_count
        lo = self.process_index * per_proc

        def decode_batch(batch_idx: int) -> dict:
            idxs = order[batch_idx * bs:(batch_idx + 1) * bs][lo:lo + per_proc]
            samples = list(pool.map(self.dataset.load, idxs))
            return {"image": np.stack([s[0] for s in samples]), "label": np.stack([s[1] for s in samples])}

        nxt = None
        for b in range(start_batch, n_batches):
            cur = nxt if nxt is not None else decode_batch(b)
            fut = self._prefetcher.submit(decode_batch, b + 1) if b + 1 < n_batches else None
            yield cur
            nxt = fut.result() if fut is not None else None


class InfiniteLoader:
    """A never-ending batch stream that reshuffles each pass."""

    def __init__(self, loader: Loader):
        if len(loader) == 0:
            raise ValueError(
                f"target stream is empty: dataset of {len(loader.dataset)} samples yields 0 batches "
                f"of {loader.batch_size} (drop_last={loader.drop_last}); shrink the batch or "
                "enlarge the dataset"
            )
        self.loader = loader
        self._it = iter(loader)

    def set_position(self, batches_consumed: int) -> None:
        """Jump to where the stream would be after ``batches_consumed``
        batches from a fresh start: the pass and the offset within it."""
        n = len(self.loader)
        self.loader.set_epoch(batches_consumed // n)
        self._it = self.loader.iter_from(batches_consumed % n)

    def __next__(self) -> dict:
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)

    def __iter__(self):
        return self


def prefetch_to_device(iterator, device, depth: int = 2):
    """Yield each batch of numpy arrays (a dict or a tuple) as tensors on
    ``device``, ``depth`` batches ahead of the consumer (at least one).

    On a CUDA device each array is copied into pinned host memory and from
    there to the device with ``non_blocking=True`` on a side stream; the
    consumer's stream waits on the copy's event before the batch is handed
    out, and the device tensors are marked as used on that stream. The
    pinned buffers stay referenced until the copy's event has completed, so
    none is freed for reuse (and overwritten) in the middle of its copy. On
    the CPU the arrays become tensors without a copy."""
    device = torch.device(device)
    depth = max(1, depth)
    if device.type != "cuda":
        for batch in iterator:
            yield _map_batch(batch, lambda a: torch.from_numpy(np.asarray(a)).to(device))
        return

    stream = torch.cuda.Stream(device)
    inflight = collections.deque()  # (device batch, copy event, pinned batch)
    retired = collections.deque()  # (copy event, pinned batch) handed out, copy maybe running

    def put(batch):
        pinned = _map_batch(batch, lambda a: torch.from_numpy(np.asarray(a)).pin_memory())
        with torch.cuda.stream(stream):
            on_device = _map_batch(pinned, lambda t: t.to(device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        return on_device, event, pinned

    it = iter(iterator)
    for batch in it:
        inflight.append(put(batch))
        if len(inflight) >= depth:
            break
    while inflight:
        on_device, event, pinned = inflight.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        _map_batch(on_device, lambda t: t.record_stream(consumer))
        retired.append((event, pinned))
        while retired and retired[0][0].query():
            retired.popleft()
        nxt = next(it, None)
        if nxt is not None:
            inflight.append(put(nxt))
        yield on_device


def _map_batch(batch, fn):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return tuple(fn(v) for v in batch)


def zip_source_target(source_iter, target_inf: InfiniteLoader):
    """Pair each source batch with the next target batch."""
    for batch in source_iter:
        tgt = next(target_inf)
        yield {**batch, "target_image": tgt["image"]}


def lookahead(iterator, depth: int = 1):
    """Run ``iterator`` ``depth`` items ahead on a worker thread, so the
    consumer's device work overlaps the decode."""
    it = iter(iterator)
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="lookahead") as ex:
        futures = collections.deque()
        for _ in range(max(1, depth)):
            futures.append(ex.submit(next, it, _SENTINEL))
        while futures:
            item = futures.popleft().result()
            if item is _SENTINEL:
                break
            futures.append(ex.submit(next, it, _SENTINEL))
            yield item


_SENTINEL = object()


def eval_batches(dataset: SegmentationDataset, batch_size: int, num_workers: int = 8,
                 process_index: int = 0, process_count: int = 1
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(images, labels, valid) batches in dataset order; the last batch is
    padded with zero images whose ``valid`` is False. Each process decodes
    only its contiguous ``batch_size / process_count`` slice of a batch."""
    n = len(dataset)
    if batch_size % process_count:
        raise ValueError(f"eval batch {batch_size} not divisible by {process_count} hosts")
    per = batch_size // process_count
    h, w = dataset.size
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for start in range(0, n, batch_size):
            hi = min(start + batch_size, n)
            lo = start + process_index * per
            idxs = list(range(lo, min(lo + per, hi)))
            if idxs:
                samples = list(pool.map(dataset.load, idxs))
                images = np.stack([s[0] for s in samples])
                labels = np.stack([s[1] for s in samples])
            else:  # this process's slice is all padding
                images = np.zeros((0, h, w, 3), np.uint8)
                labels = np.zeros((0, h, w), np.int32)
            valid = np.ones(len(idxs), bool)
            pad = per - len(idxs)
            if pad:
                images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
                labels = np.concatenate([labels, np.zeros((pad,) + labels.shape[1:], labels.dtype)])
                valid = np.concatenate([valid, np.zeros(pad, bool)])
            yield images, labels, valid
