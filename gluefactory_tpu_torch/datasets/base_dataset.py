"""Dataset base class and batch loader (counterpart of
gluefactory_tpu/datasets/base_dataset.py: `collate`, `BaseDataset`,
`get_data_loader`).

Datasets give numpy samples on the host; the loader collates fixed-shape
batches in order on a background thread, `prefetch` batches ahead, so that
reading overlaps the model on the card. Shuffling and sharding wait for the
training datasets (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import collections.abc
import queue
import threading
from typing import ClassVar, Iterator, Mapping

import numpy as np

from ..utils.config import Config, merge


def collate(samples: list):
    """Stack a list of sample dicts into batched numpy arrays; strings become
    lists."""
    elem = samples[0]
    if isinstance(elem, Mapping):
        return {k: collate([s[k] for s in samples]) for k in elem}
    if isinstance(elem, (str, bytes)):
        return list(samples)
    if isinstance(elem, np.ndarray):
        return np.stack(samples, 0)
    if isinstance(elem, (int, float, bool, np.number)):
        return np.asarray(samples)
    if elem is None:
        return None
    if isinstance(elem, collections.abc.Sequence):
        return [collate(list(x)) for x in zip(*samples)]
    raise TypeError(f"cannot collate {type(elem)}")


class _Prefetch:
    """Iterate `make_batches()` on a background thread, `depth` batches ahead.
    Exposes `.dataset` (the indexable split)."""

    def __init__(self, make_batches, depth: int, dataset=None):
        self.dataset = dataset
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        threading.Thread(target=self._worker, args=(make_batches,), daemon=True).start()

    def _worker(self, make_batches):
        try:
            for batch in make_batches():
                self._queue.put(batch)
        except BaseException as e:  # handed to the consumer
            self._queue.put(e)
        self._queue.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item


class BaseDataset:
    """Subclasses define default_conf, `_init(conf)` and `get_dataset(split)`
    returning an indexable split."""

    base_default_conf: ClassVar[dict] = {
        "name": None,
        "train_batch_size": 2,
        "val_batch_size": 2,
        "test_batch_size": 1,
        "batch_size": None,  # overrides the per-split sizes if set
        "prefetch": 2,
    }
    default_conf: ClassVar[dict] = {}

    def __init__(self, conf=None):
        self.conf = Config(merge(self.base_default_conf, self.default_conf, conf or {}))
        self._init(self.conf)

    def _init(self, conf):
        pass

    def get_dataset(self, split: str):
        raise NotImplementedError

    def batch_size(self, split: str) -> int:
        if self.conf.get("batch_size"):
            return int(self.conf.batch_size)
        return int(self.conf.get(f"{split}_batch_size"))

    def get_data_loader(self, split: str) -> Iterator[dict]:
        """Collated batches of a split, in order; an incomplete last batch is
        dropped."""
        dataset = self.get_dataset(split)
        bs = self.batch_size(split)
        if len(dataset) < bs:
            raise ValueError(f"Split {split!r} has {len(dataset)} samples < batch size {bs}")

        def make_batches():
            for start in range(0, len(dataset) - bs + 1, bs):
                yield collate([dataset[i] for i in range(start, start + bs)])

        return _Prefetch(make_batches, max(int(self.conf.prefetch), 1), dataset=dataset)


__all__ = ["BaseDataset", "collate"]
