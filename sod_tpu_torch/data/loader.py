"""Host data loader of the port (twin of ``sod_tpu/data/loader.py``):
threaded decode/augment with batch prefetch, and the padded train collate.

* ``collate_train``: per-sample all-zero mask rows dropped, samples left
  with no masks marked invalid instead of shrinking the batch; GT stacks
  padded to ``max_gt_masks`` rows with a validity mask; contrastive labels
  a stable crc32 hash of the filename mod 10000;
* ``DataLoader``: shuffled by ``default_rng([seed, epoch])``, samples
  fetched by a thread pool or, with ``use_processes``, by forked worker
  processes, ``prefetch_batches`` collated batches queued.  No index
  sharding over processes (multi-host, ROADMAP item 12).
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import zlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional

import numpy as np


def stable_label(filename: str, mod: int = 10000) -> int:
    return zlib.crc32(filename.encode("utf-8")) % mod


def collate_train(samples: List[dict], max_gt_masks: int,
                  batch_size: Optional[int] = None) -> dict:
    """Pad a list of samples into one fixed-shape batch dict.

    Samples carrying ``image_u8`` (dataset ``train_u8`` mode) collate to a
    uint8 batch under the same ``"image"`` key — the train step normalizes
    on device, quartering host->device traffic."""
    n = len(samples)
    batch_size = batch_size or n
    u8 = "image_u8" in samples[0]
    key = "image_u8" if u8 else "image"
    h, w = samples[0][key].shape[:2]

    images = np.zeros((batch_size, h, w, 3), np.uint8 if u8 else np.float32)
    # u8 mode ships the (binary) masks as uint8 too — the train step's
    # astype(float32) runs on DEVICE, so the host skips a 4x-sized cast
    # and the transfer shrinks 4x (same trick as the image normalize)
    gt = np.zeros((batch_size, max_gt_masks, h, w),
                  np.uint8 if u8 else np.float32)
    valid = np.zeros((batch_size, max_gt_masks), bool)
    labels = np.zeros((batch_size,), np.int32)
    filenames: List[str] = []

    for i, s in enumerate(samples):
        images[i] = s[key]
        masks = s["masks"]
        # drop empty mask rows (ref base_dataset.py:134-135 + duts collate)
        keep = masks.reshape(masks.shape[0], -1).sum(-1) > 0
        masks = masks[keep][:max_gt_masks]
        m = masks.shape[0]
        if m > 0:
            gt[i, :m] = masks if u8 else masks.astype(np.float32)
            valid[i, :m] = True
        labels[i] = stable_label(s["filename"])
        filenames.append(s["filename"])

    return {"image": images, "gt_masks": gt, "gt_valid": valid,
            "labels": labels, "filename": filenames}


class DataLoader:
    """Iterates batches with threaded sample loading and prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4,
                 collate_fn: Optional[Callable[[List[dict]], dict]] = None,
                 drop_last: bool = False, seed: int = 0,
                 prefetch_batches: int = 2, use_processes: bool = False):
        """:param use_processes: decode and augment in forked worker
        processes instead of threads (the augmentations are NumPy and hold
        the GIL, so threads stop scaling past ~2x).  The dataset reaches
        each worker once, through the pool's initializer; only indices and
        samples cross the pipe.  The fork may come after CUDA is up in this
        process: ``__getitem__`` must run NumPy/PIL only, and the workers
        run torch on one intra-op thread."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.collate_fn = collate_fn or (lambda xs: xs)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.use_processes = use_processes
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng([self.seed, self._epoch]).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that aborts when the consumer walked away
            (mid-epoch break, e.g. Trainer debug) — a plain ``q.put``
            would block forever on a full queue and leak this thread and
            its pool per abandoned epoch."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def make_pool():
            if self.use_processes:
                return ProcessPoolExecutor(
                    self.num_workers, mp_context=mp.get_context("fork"),
                    initializer=_init_worker, initargs=(self.dataset,))
            return ThreadPoolExecutor(self.num_workers)

        def fetch(pool, idxs):
            if self.use_processes:
                return pool.map(_getitem_worker, [int(i) for i in idxs])
            return pool.map(self.dataset.__getitem__, idxs)

        def produce():
            try:
                with make_pool() as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(fetch(pool, idxs))
                        if not put(self.collate_fn(samples)):
                            return
            except BaseException as e:  # noqa: BLE001
                # surface loader errors at the consumer — a dying producer
                # would otherwise leave the consumer blocked on q.get()
                # forever (e.g. one corrupt JPEG freezing the whole run)
                put(_Error(e))
                return
            put(_END)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _Error):
                    raise item.exc
                yield item
        finally:
            stop.set()


_WORKER_DATASET = None


def _init_worker(dataset):
    """Process-pool initializer: the dataset, inherited through the fork,
    kept as a worker global; torch (imported by the augmentations) held to
    one intra-op thread, so no worker enters the parent's thread pool."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    import torch

    torch.set_num_threads(1)


def _getitem_worker(i: int) -> dict:
    """Only the integer index crosses the pipe to the worker."""
    return _WORKER_DATASET[i]


_END = object()


class _Error:
    """Producer-side exception, re-raised in the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc
