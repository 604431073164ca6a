"""Tee stdout and stderr to a log file (counterpart of
gluefactory_tpu/utils/stdout_capturing.py). A Python-level tee: the
program's output goes through Python's streams. The trainer does not call
it, as the JAX trainer does not."""

from __future__ import annotations

import sys
from contextlib import contextmanager
from pathlib import Path


class _Tee:
    def __init__(self, stream, fh):
        self.stream = stream
        self.fh = fh

    def write(self, data):
        self.stream.write(data)
        self.fh.write(data)
        self.fh.flush()

    def flush(self):
        self.stream.flush()
        self.fh.flush()

    def isatty(self):
        return getattr(self.stream, "isatty", lambda: False)()

    def fileno(self):
        return self.stream.fileno()


@contextmanager
def capture_outputs(path: str | Path):
    """Mirror stdout and stderr into `path` (appended) for the duration of
    the context; the streams are put back after it, also on an error."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as fh:
        out, err = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = _Tee(out, fh), _Tee(err, fh)
        try:
            yield
        finally:
            sys.stdout, sys.stderr = out, err


__all__ = ["capture_outputs"]
