"""Host-side batching: shuffling, thread or process workers and prefetch.

Counterpart of `micformer_tpu/data/loader.py`. A producer thread assembles
compact batches ahead of the consumer: images as float16 and one-hot labels
collapsed to uint8 class indices, about ten times fewer bytes than f32
one-hot; the trainer upcasts and one-hots them on the device. Augmentation
does not happen here (see `data/transforms.py`). `make_fetch_pool` gives
prediction's case prefetch a pool of threads or of worker processes.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch


# the dataset of a worker process, shipped once by the pool's initializer
_WORKER_DS = None


def _proc_init(ds):
    global _WORKER_DS
    _WORKER_DS = ds


def _proc_fetch(i):
    return _WORKER_DS[int(i)]


class VisitSeeds:
    """Per-visit generators of an indexable dataset: item i's k-th visit
    draws from SeedSequence([seed, i, k]), so the draws do not depend on how
    threads interleave. The visit counters live in the process that calls
    it: under process workers each worker counts the visits it served, so
    the draws depend on which worker fetched an item (as with the JAX
    package's forked workers). Pickles for a spawned worker, which gets a
    lock of its own."""

    def __init__(self, seed: int):
        self.seed = seed
        self._lock = threading.Lock()
        self._visits: dict = {}

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "_lock"}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def __call__(self, i: int) -> np.random.Generator:
        with self._lock:
            k = self._visits.get(i, 0)
            self._visits[i] = k + 1
        return np.random.default_rng(np.random.SeedSequence([self.seed, i, k]))


def make_fetch_pool(dataset, workers: int, mode: str = "thread"):
    """(pool, fetch_one) for parallel dataset[i] fetches; fetch_one(i)
    returns a future. mode "thread": threads, which overlap the numpy and
    file work that releases the GIL; "process": worker processes started
    with spawn (the parent may hold a CUDA context, which fork must not
    copy), each sent the dataset once. The caller shuts the pool down."""
    if mode == "process":
        pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                   initializer=_proc_init, initargs=(dataset,))
        return pool, lambda i: pool.submit(_proc_fetch, int(i))
    if mode != "thread":
        raise ValueError(f"unknown worker mode {mode!r}")
    pool = ThreadPoolExecutor(workers)
    return pool, lambda i: pool.submit(dataset.__getitem__, int(i))


def _stack_batch(samples):
    """(images, labels, meta) of a list of sample dicts, as CPU tensors, in
    the compact form: images float16 [B, C, D, H, W] and labels uint8 class
    indices [B, D, H, W] (the argmax of a one-hot label)."""
    images = np.stack([np.asarray(s["image"], dtype=np.float16) for s in samples])
    labs = []
    for s in samples:
        lab = np.asarray(s["label"])
        labs.append(np.argmax(lab, axis=0).astype(np.uint8) if lab.ndim == 4
                    else lab.astype(np.uint8))
    labels = np.stack(labs)
    meta = {"patient_id": [s["patient_id"] for s in samples],
            "crop_indexes": [s.get("crop_indexes") for s in samples]}
    return torch.from_numpy(images), torch.from_numpy(labels), meta


class DataLoader:
    """Deterministic batching over an indexable dataset: batch_size,
    shuffle (a fresh permutation per epoch from `seed`), and `workers` > 1
    threads or spawned processes (`worker_mode`, see make_fetch_pool) that
    fetch the samples of a batch concurrently (batch order does not depend
    on the worker count). Up to PREFETCH batches wait ready. `close()`
    shuts the workers down.

    A process worker holds its own copy of the dataset, so a dataset's
    `VisitSeeds` counts per worker (see there).

    Data parallelism: with `world` > 1 the loader of rank `rank` yields
    only its rows [r·b/W, (r+1)·b/W) of each global batch b that a single
    process's loader yields (the same seed gives the same order on every
    rank), and fetches only those samples; `len()` is the same on every
    rank. A global batch, the last one included, that W does not divide is
    refused here, before the first step."""

    PREFETCH = 2

    def __init__(self, dataset, batch_size=1, shuffle=False, seed=0, workers=0,
                 worker_mode="thread", rank=0, world=1):
        n = len(dataset)
        for b in {batch_size, n % batch_size or batch_size}:
            if b % world:
                raise ValueError(f"a global batch of {b} ({n} samples in batches of "
                                 f"{batch_size}) does not split over data={world} ranks")
        self.rank, self.world = rank, world
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = int(workers)
        self.worker_mode = worker_mode
        self._pool = self._fetch_one = None
        if self.workers > 1:
            self._pool, self._fetch_one = make_fetch_pool(dataset, self.workers, worker_mode)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def peek_shape(self):
        """[B, C, D, H, W] of a full global batch, from the first sample
        (without iterating)."""
        return (self.batch_size,) + tuple(np.asarray(self.dataset[0]["image"]).shape)

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng = np.random.default_rng(self._rng.integers(0, 2**63))
            self._rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i: i + self.batch_size]
            per = len(chunk) // self.world
            yield chunk[self.rank * per:(self.rank + 1) * per]

    def _fetch(self, chunk):
        if self._pool is not None:
            return [f.result() for f in [self._fetch_one(j) for j in chunk]]
        return [self.dataset[int(j)] for j in chunk]

    def close(self):
        """Shut the worker pool down (its processes, in process mode)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = self._fetch_one = None

    def _produce(self, out_q: queue.Queue, stop: threading.Event):
        try:
            for chunk in self._index_batches():
                item = _stack_batch(self._fetch(chunk))
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            out_q.put(None)
        except BaseException as e:  # surface worker errors to the consumer
            out_q.put(e)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
