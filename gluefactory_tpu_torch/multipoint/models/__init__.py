"""Multispectral detectors and descriptors."""
