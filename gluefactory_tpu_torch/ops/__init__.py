"""Tensor ops of the port; each kernel op keeps its plain version beside it."""
