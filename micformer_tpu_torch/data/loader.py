"""Host-side batching: shuffling, thread workers and prefetch.

Counterpart of `micformer_tpu/data/loader.py` (thread workers only). A
producer thread assembles compact batches ahead of the consumer: images as
float16 and one-hot labels collapsed to uint8 class indices, about ten times
fewer bytes than f32 one-hot; the trainer upcasts and one-hots them on the
device. Augmentation does not happen here (see `data/transforms.py`).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


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
    threads that fetch the samples of a batch concurrently (batch order does
    not depend on the worker count). Up to PREFETCH batches wait ready."""

    PREFETCH = 2

    def __init__(self, dataset, batch_size=1, shuffle=False, seed=0, workers=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = int(workers)
        self._pool = ThreadPoolExecutor(self.workers) if self.workers > 1 else None
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng = np.random.default_rng(self._rng.integers(0, 2**63))
            self._rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            yield order[i: i + self.batch_size]

    def _fetch(self, chunk):
        if self._pool is not None:
            futures = [self._pool.submit(self.dataset.__getitem__, int(j)) for j in chunk]
            return [f.result() for f in futures]
        return [self.dataset[int(j)] for j in chunk]

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
