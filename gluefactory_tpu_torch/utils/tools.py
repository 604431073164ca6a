"""Metric aggregators, the AUC of an error-recall curve, `Timer` and
`set_seed` (counterpart of gluefactory_tpu/utils/tools.py; numpy, the same
semantics)."""

from __future__ import annotations

import random
import time
from collections.abc import Iterable

import numpy as np


def _to_list(x) -> list:
    return np.asarray(x).reshape(-1).tolist()


class AverageMetric:
    def __init__(self):
        self._sum = 0.0
        self._num = 0

    def update(self, tensor):
        arr = np.asarray(tensor, dtype=np.float64).reshape(-1)
        arr = arr[~np.isnan(arr)]
        self._sum += arr.sum()
        self._num += len(arr)

    def compute(self):
        return np.nan if self._num == 0 else self._sum / self._num


class FAverageMetric(AverageMetric):
    """AverageMetric that also keeps all elements."""

    def __init__(self):
        super().__init__()
        self._elements = []

    def update(self, tensor):
        self._elements += _to_list(tensor)
        super().update(tensor)


class MedianMetric:
    def __init__(self):
        self._elements = []

    def update(self, tensor):
        self._elements += _to_list(tensor)

    def compute(self):
        return np.nan if not self._elements else np.nanmedian(self._elements)


class QuantileMetric:
    def __init__(self, q: float = 0.05):
        self._elements = []
        self.q = q

    def update(self, tensor):
        self._elements += _to_list(tensor)

    def compute(self):
        return np.nan if not self._elements else np.nanquantile(self._elements, self.q)


class RecallMetric:
    def __init__(self, ths, elements=None):
        self._elements = list(elements) if elements is not None else []
        self.ths = ths

    def update(self, tensor):
        self._elements += _to_list(tensor)

    def compute(self):
        if isinstance(self.ths, Iterable):
            return [self._compute(th) for th in self.ths]
        return self._compute(self.ths)

    def _compute(self, th):
        if not self._elements:
            return np.nan
        return float((np.array(self._elements) < th).sum() / len(self._elements))


class PRMetric:
    def __init__(self):
        self.labels = []
        self.predictions = []

    def update(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if mask is not None:
            mask = np.asarray(mask, bool)
            labels, predictions = labels[mask], predictions[mask]
        self.labels += labels.reshape(-1).tolist()
        self.predictions += predictions.reshape(-1).tolist()

    def compute(self):
        return np.array(self.labels), np.array(self.predictions)

    def reset(self):
        self.labels, self.predictions = [], []


def cal_error_auc(errors, thresholds):
    """AUC of the error-recall curve at each threshold (trapezoid over the
    sorted errors, rounded to 4 decimals)."""
    errors = np.asarray(errors, dtype=np.float64)
    if len(errors) == 0:
        return [np.nan] * len(thresholds)
    errors = np.sort(errors)
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last_index = np.searchsorted(errors, t)
        r = np.r_[recall[:last_index], recall[last_index - 1]]
        e = np.r_[errors[:last_index], t]
        aucs.append(float(np.round(np.trapezoid(r, x=e) / t, 4)))
    return aucs


class AUCMetric:
    def __init__(self, thresholds, elements=None):
        self._elements = list(elements) if elements is not None else []
        self.thresholds = thresholds if isinstance(thresholds, list) else [thresholds]

    def update(self, tensor):
        self._elements += _to_list(tensor)

    def compute(self):
        if not self._elements:
            return np.nan
        return cal_error_auc(self._elements, self.thresholds)


METRICS = {
    "mean": AverageMetric,
    "fmean": FAverageMetric,
    "median": MedianMetric,
    "recall": RecallMetric,
    "quantile": QuantileMetric,
    "pr": PRMetric,
    "auc": AUCMetric,
}

class Timer:
    """Context timer; prints the elapsed seconds when it has a name."""

    def __init__(self, name=None):
        self.name = name

    def __enter__(self):
        self.tstart = time.perf_counter()
        return self

    def __exit__(self, *_):
        self.duration = time.perf_counter() - self.tstart
        if self.name is not None:
            print(f"[{self.name}] Elapsed: {self.duration:.4f} s")


def set_seed(seed: int):
    """Seed numpy's, Python's and torch's global generators; returns a
    `RandomState(seed)`."""
    import torch

    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return np.random.RandomState(seed)


__all__ = [
    "AverageMetric", "FAverageMetric", "MedianMetric", "QuantileMetric",
    "RecallMetric", "PRMetric", "AUCMetric", "METRICS", "cal_error_auc", "Timer", "set_seed",
]
