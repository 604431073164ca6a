"""Benchmarks of the port (counterpart of gluefactory_tpu/eval): HPatches
(`eval.hpatches`); the others wait (ROADMAP Queue 1 item 6)."""
