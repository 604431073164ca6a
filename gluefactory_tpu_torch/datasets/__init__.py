"""Datasets of the port (numpy samples on the host)."""

from .base_dataset import BaseDataset, collate, get_dataset  # noqa: F401
