"""Command-line scripts of the port (counterpart of gluefactory_tpu/scripts)."""
