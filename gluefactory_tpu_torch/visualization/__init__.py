"""Figures without matplotlib: numpy rasterisers (`viz2d`) and the training
match figures (`visualize_batch`)."""
