"""Multispectral evaluation helpers."""
