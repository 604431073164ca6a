"""Pair-parallel matching across processes (counterpart of
gluefactory_tpu/parallel/pair_matching.py)."""
