"""Experiment summary writer (counterpart of
gluefactory_tpu/utils/summary.py).

Appends scalars and histograms to `<dir>/events.jsonl`, one JSON object a
line: `{"step", "ts", <name>: value, ...}` and, for a histogram,
`{<name>__hist: {"counts", "edges", "mean", "max"}}`. The JAX writer also
mirrors to TensorBoard and saves matplotlib figures; the card's machine has
neither, so there are no figures here: `figure` raises (ROADMAP Queue 1
item 6, `visualization/`). With `train.pr_curves` the trainer writes
`val/match_AP` but not the JAX package's PR figure.
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

    def figure(self, step: int, name: str, fig):
        raise NotImplementedError(
            "figures need matplotlib, which the port does not use; the visualisation module "
            "is not ported yet (ROADMAP Queue 1 item 6)")

    def close(self) -> None:
        self._events.close()
