"""Multispectral evaluation helpers, the detector losses and box NMS."""
