"""Dataset base class, batch loaders and the registry (counterpart of
gluefactory_tpu/datasets/base_dataset.py: `collate`, `BaseDataset`,
`get_data_loader`, `get_overfit_loader`, `get_dataset`).

Datasets give numpy samples on the host; the loader collates fixed-shape
batches on a background thread, `prefetch` batches ahead, so that reading
overlaps the model on the card. `num_workers` > 0 builds the samples on a
thread pool, `num_workers` of them in flight across batch boundaries (the
warps, filters and renderers release the GIL). The
train split is shuffled by `RandomState(seed + epoch)`, and a split with
`set_epoch` is told the epoch before the first sample. Incomplete last
batches are dropped. Across processes (`shard=(rank, world)`) rank r loads
only its slice `[r B/W, (r+1) B/W)` of each global batch of the one-process
order, so the ranks together see the one-process samples and each renders
1/W of them; a global batch that W does not divide raises, as the JAX
package's `shard_batch(strict=True)` does.
"""

from __future__ import annotations

import collections
import collections.abc
import importlib
import importlib.util
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import ClassVar, Iterator, Mapping

import numpy as np

from ..geometry.wrappers import TensorWrapper
from ..utils.config import Config, merge


def collate(samples: list):
    """Stack a list of sample dicts into batched numpy arrays; strings become
    lists, a `Pose` or `Camera` (CPU tensors) is stacked leaf by leaf."""
    elem = samples[0]
    if isinstance(elem, TensorWrapper):
        return type(elem).stack(samples)
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
    Exposes `.dataset` (the indexable split). The thread stops after its
    current batch once the iterator is dropped or the main thread ends, and
    the interpreter waits for it: torch ops still running in a thread at
    interpreter exit abort the process."""

    def __init__(self, make_batches, depth: int, dataset=None):
        self.dataset = dataset
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        threading.Thread(target=_produce,
                         args=(make_batches, self._queue, self._done, self._stop)).start()

    def __del__(self):
        self._stop.set()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item


def _produce(make_batches, out: queue.Queue, done, stop: threading.Event) -> None:
    def put(item) -> bool:
        while not stop.is_set() and threading.main_thread().is_alive():
            try:
                out.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    try:
        batches = make_batches()
        for batch in batches:
            if not put(batch):
                batches.close()
                return
    except BaseException as e:  # handed to the consumer
        put(e)
    put(done)


class BaseDataset:
    """Subclasses define default_conf, `_init(conf)` and `get_dataset(split)`
    returning an indexable split."""

    base_default_conf: ClassVar[dict] = {
        "name": None,
        "num_workers": 0,
        "train_batch_size": 2,
        "val_batch_size": 2,
        "test_batch_size": 1,
        "batch_size": None,  # overrides the per-split sizes if set
        "shuffle_training": True,
        "seed": 0,
        "prefetch": 2,
    }
    default_conf: ClassVar[dict] = {}

    def __init__(self, conf=None, device="cuda"):
        self.conf = Config(merge(self.base_default_conf, self.default_conf, conf or {}))
        self.device = device  # where a dataset that runs a model (features.do) runs it
        self._init(self.conf)

    def _init(self, conf):
        pass

    def get_dataset(self, split: str):
        raise NotImplementedError

    def batch_size(self, split: str) -> int:
        if self.conf.get("batch_size"):
            return int(self.conf.batch_size)
        return int(self.conf.get(f"{split}_batch_size"))

    def _shard_size(self, split: str, shard: tuple) -> int:
        """The pairs of a global batch that one of `shard[1]` ranks loads."""
        bs, world = self.batch_size(split), shard[1]
        if bs % world:
            raise ValueError(f"the {split} batch size {bs} is not divisible by the {world} "
                             "processes; change the batch size or the process count")
        return bs // world

    def get_data_loader(self, split: str, shuffle: bool | None = None, epoch: int = 0,
                        shard: tuple = (0, 1)) -> Iterator[dict]:
        """Collated batches of a split; `shuffle` defaults to True on the
        train split (`shuffle_training`); `shard=(rank, world)` gives rank's
        slice of each global batch."""
        dataset = self.get_dataset(split)
        if hasattr(dataset, "set_epoch"):
            dataset.set_epoch(epoch)
        bs = self.batch_size(split)
        per = self._shard_size(split, shard)
        first = shard[0] * per
        if len(dataset) < bs:
            raise ValueError(f"Split {split!r} has {len(dataset)} samples < batch size {bs}")
        if shuffle is None:
            shuffle = split == "train" and self.conf.shuffle_training
        num_workers = int(self.conf.num_workers)

        def make_batches():
            order = np.arange(len(dataset))
            if shuffle:
                np.random.RandomState(self.conf.seed + epoch).shuffle(order)
            starts = range(first, len(order) - bs + 1 + first, bs)
            if num_workers > 0:
                # samples are submitted ahead across batch boundaries, so that
                # the workers stay busy at any batch size (one pair a batch in
                # the evaluations)
                ahead = -(-num_workers // per)  # batches in flight beside the current one
                with ThreadPoolExecutor(num_workers) as pool:
                    pending = collections.deque()
                    for start in starts:
                        pending.append([pool.submit(dataset.__getitem__, int(i))
                                        for i in order[start:start + per]])
                        if len(pending) > ahead:
                            yield collate([f.result() for f in pending.popleft()])
                    while pending:
                        yield collate([f.result() for f in pending.popleft()])
            else:
                for start in starts:
                    yield collate([dataset[int(i)] for i in order[start:start + per]])

        return _Prefetch(make_batches, max(int(self.conf.prefetch), 1), dataset=dataset)

    def get_overfit_loader(self, split: str, length: int = 100, shard: tuple = (0, 1)):
        """One batch of the split at epoch 0 (`shard`'s slice of it),
        `length` times. (The JAX package's version reads an undefined
        `epoch` here and raises NameError on a dataset with `set_epoch`.)"""
        dataset = self.get_dataset(split)
        if hasattr(dataset, "set_epoch"):
            dataset.set_epoch(0)
        per = self._shard_size(split, shard)
        batch = collate([dataset[i % len(dataset)]
                         for i in range(shard[0] * per, (shard[0] + 1) * per)])

        def make_batches():
            for _ in range(length):
                yield batch

        return _Prefetch(make_batches, 1, dataset=dataset)


def get_dataset(name: str):
    """The dataset class of a module of this package (or an importable
    path): its `__main_dataset__`, else its one BaseDataset subclass."""
    base = __name__.rsplit(".", 1)[0]
    for path in (f"{base}.{name}", name):
        try:
            found = importlib.util.find_spec(path) is not None
        except ModuleNotFoundError:
            found = False
        if found:
            mod = importlib.import_module(path)
            main = getattr(mod, "__main_dataset__", None)
            if main is not None:
                return main
            classes = [v for v in mod.__dict__.values() if isinstance(v, type)
                       and issubclass(v, BaseDataset) and v is not BaseDataset]
            if len(classes) == 1:
                return classes[0]
    raise RuntimeError(f"Dataset {name} not found")


__all__ = ["BaseDataset", "collate", "get_dataset"]
