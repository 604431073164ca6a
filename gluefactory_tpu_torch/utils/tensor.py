"""Nested dict/array helpers (counterpart of gluefactory_tpu/utils/tensor.py):
leaves are numpy arrays or torch tensors; a `Pose` or `Camera` is mapped
leaf by leaf and stays a wrapper."""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.wrappers import TensorWrapper


def map_tensor(tree, fn):
    """Apply fn to every array leaf of a nested dict/list/tuple, keeping the
    structure; strings, bytes and None pass through."""
    if isinstance(tree, dict):
        return {k: map_tensor(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensor(v, fn) for v in tree)
    if isinstance(tree, (str, bytes)) or tree is None:
        return tree
    if isinstance(tree, TensorWrapper):
        return tree.map(fn)
    return fn(tree)


def to_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def batch_to_numpy(batch):
    return map_tensor(batch, to_numpy)


def batch_to_device(batch, device):
    """Numeric numpy leaves and tensors of a batch as tensors on `device`;
    strings and lists of strings stay as they are."""

    def move(x):
        if torch.is_tensor(x):
            return x.to(device)
        arr = np.asarray(x)
        if arr.dtype.kind in "biuf":
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        return x

    return map_tensor(batch, move)


def index_batch(batch):
    """Iterate over the items of a batched dict."""

    def first_len(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                n = first_len(v)
                if n is not None:
                    return n
            return None
        if hasattr(tree, "shape") and len(tree.shape) > 0:
            return tree.shape[0]
        if isinstance(tree, list):
            return len(tree)
        return None

    for i in range(first_len(batch)):
        yield map_tensor(batch, lambda x: x[i] if hasattr(x, "shape") and len(x.shape) > 0 else x)


__all__ = ["map_tensor", "to_numpy", "batch_to_numpy", "batch_to_device", "index_batch"]
