"""Experiment summary writer (counterpart of
gluefactory_tpu/utils/summary.py).

Appends scalars and histograms to `<dir>/events.jsonl`, one JSON object a
line: `{"step", "ts", <name>: value, ...}` and, for a histogram,
`{<name>__hist: {"counts", "edges", "mean", "max"}}`. `figure` writes a
`visualization.viz2d.Figure` (or an image array) as
`<dir>/figures/<name>_<step>.png` ("/" in the name as "_"), with the port's
own PNG encoder. The JAX writer also mirrors to TensorBoard, which the
port does not use.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

__all__ = ["ExperimentWriter"]


class ExperimentWriter:
    def __init__(self, output_dir: Path | str):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._events = open(self.dir / "events.jsonl", "a")

    def _write(self, step: int, record: dict) -> None:
        self._events.write(json.dumps({"step": int(step), "ts": time.time(), **record}) + "\n")
        self._events.flush()

    def scalars(self, step: int, values: dict, prefix: str = "") -> None:
        clean = {}
        for k, v in values.items():
            try:
                clean[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        self._write(step, clean)

    def histogram(self, step: int, name: str, values) -> None:
        """Bin counts of a value distribution (at most 16 bins)."""
        vals = np.asarray(values, np.float64).reshape(-1)
        vals = vals[np.isfinite(vals)]
        if vals.size == 0:
            return
        counts, edges = np.histogram(vals, bins=min(16, max(1, vals.size)))
        self._write(step, {f"{name}__hist": {
            "counts": counts.tolist(), "edges": np.round(edges, 6).tolist(),
            "mean": float(vals.mean()), "max": float(vals.max())}})

    def figure(self, step: int, name: str, fig) -> Path:
        from ..visualization.viz2d import save_plot

        fig_dir = self.dir / "figures"
        fig_dir.mkdir(exist_ok=True)
        return save_plot(fig_dir / f"{name.replace('/', '_')}_{step}.png", fig)

    def close(self) -> None:
        self._events.close()
