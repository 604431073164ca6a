"""Datasets of the port (numpy samples on the host)."""
