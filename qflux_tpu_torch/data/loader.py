"""Host-side batching and prefetch.

Counterpart of qflux_tpu/data/loader.py, batch for batch:

  * a deterministic shuffle: numpy's default_rng(seed + epoch);
  * shape buckets: with bucket_by_shape, samples are grouped by a key so
    every batch has one shape.  A cached sample's key is the shape in its
    `image_latents` npz header (no array is read); a sample without one is
    keyed by its first item, which the epoch then reuses;
  * drop_last, and with bucket_by_shape the part-filled buckets at the end
    of the epoch when drop_last is off;
  * a background thread that collates batches into a bounded queue
    (`prefetch` batches, at least one), and with num_workers > 1 a thread
    pool that fetches items in parallel while batches keep their order.
    A worker's exception is raised in the consumer.

The loader stays in numpy: its threads never touch torch or the device;
the Trainer moves each batch to the device on the main thread.  When the
consumer stops early (a fit that reaches max_train_steps), the producer
stops too.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from qflux_tpu_torch.data.collate import collate
from qflux_tpu_torch.data.dataset import ImageDataset
from qflux_tpu_torch.utils.instantiate import instantiate_class

_END = object()


class DataLoader:
    def __init__(self, dataset: ImageDataset, batch_size: int = 1, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, bucket_by_shape: bool = True,
                 prefetch: int = 2, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.bucket_by_shape = bucket_by_shape
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self) -> list[list[int]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        if not self.bucket_by_shape:
            stop = n - (n % self.batch_size if self.drop_last else 0)
            return [b for b in (list(order[i:i + self.batch_size])
                                for i in range(0, stop, self.batch_size)) if b]
        batches, buckets = [], {}
        for idx in order:
            key = self._bucket_key(int(idx))
            buckets.setdefault(key, []).append(int(idx))
            if len(buckets[key]) == self.batch_size:
                batches.append(buckets.pop(key))
        if not self.drop_last:
            batches.extend(b for b in buckets.values() if b)
        return batches

    def _bucket_key(self, idx: int):
        rec = self.dataset.samples[idx]
        if "_bucket" not in rec:
            rec["_bucket"] = self._cheap_bucket_key(rec) or self._slow_bucket_key(idx)
        return rec["_bucket"]

    def _cheap_bucket_key(self, rec):
        """("cached", image_latents shape) from the npz header, or None."""
        ds = self.dataset
        if not ds.use_cache:
            return None
        main_hash = ds.file_hashes(rec)["main_hash"]
        if not ds.cache_manager.exists(main_hash):
            return None
        shape = ds.cache_manager.array_shape(main_hash, "image_latents")
        return ("cached", shape) if shape else None

    def _slow_bucket_key(self, idx: int):
        rec = self.dataset.samples[idx]
        item = self.dataset[idx]
        if not item.get("cached") and "img_shapes" in item:
            key = tuple(item["img_shapes"])
        elif "image_latents" in item:
            key = ("cached", tuple(np.asarray(item["image_latents"]).shape))
        else:
            key = ("unknown",)
        rec["_first_item"] = item
        return key

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        self._epoch += 1
        stop = threading.Event()
        # Queue(0) would be unbounded, and the producer would collate the
        # whole epoch ahead of the consumer: prefetch 0 still hands over
        # through one slot
        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))

        def fetch(i: int):
            rec = self.dataset.samples[i]
            return rec.pop("_first_item", None) or self.dataset[i]

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                if self.num_workers > 1:
                    # parallel item fetch, batches in order, at most
                    # prefetch + 1 batches in flight
                    with ThreadPoolExecutor(self.num_workers) as ex:
                        it = iter(batches)
                        pending: deque = deque()

                        def submit_next():
                            b = next(it, None)
                            if b is not None:
                                pending.append([ex.submit(fetch, i) for i in b])

                        for _ in range(max(self.prefetch, 1) + 1):
                            submit_next()
                        while pending:
                            futs = pending.popleft()
                            if not put(collate([f.result() for f in futs])):
                                return
                            submit_next()
                else:
                    for batch_idx in batches:
                        if not put(collate([fetch(i) for i in batch_idx])):
                            return
            except Exception as e:  # raised again in the consumer
                put(e)
            put(_END)

        t = threading.Thread(target=produce, daemon=True, name="qflux-data-loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


def loader(dataset_config: dict, batch_size: int = 1, shuffle: bool = True,
           drop_last: bool = True, **kw) -> DataLoader:
    """A DataLoader over the dataset a {class_path, init_args} section names."""
    class_path = dataset_config.get("class_path", "qflux_tpu.data.dataset.ImageDataset")
    ds = instantiate_class(class_path, **dataset_config.get("init_args", {}))
    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last, **kw)
