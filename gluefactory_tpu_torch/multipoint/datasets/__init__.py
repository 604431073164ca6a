"""Multispectral datasets."""
