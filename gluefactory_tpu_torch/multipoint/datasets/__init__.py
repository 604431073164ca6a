"""Multispectral datasets and SyntheticShapes."""
