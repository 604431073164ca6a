"""Benchmarks of the port (counterpart of gluefactory_tpu/eval): the
registry and the hook the trainer calls at the end of an epoch. HPatches
(`eval.hpatches`), the synthetic homography benchmark (`eval.synthetic`)
and the synthetic relative-pose benchmark (`eval.synthetic_pose`) are
ported; the others wait (ROADMAP Queue 1 item 6)."""

from __future__ import annotations

from pathlib import Path
from typing import Any

NOT_PORTED = ("megadepth1500", "eth3d", "MP")


def get_benchmark(name: str):
    if name == "hpatches":
        from .hpatches import HPatchesPipeline

        return HPatchesPipeline
    if name == "synthetic":
        from .synthetic import SyntheticHomographyPipeline

        return SyntheticHomographyPipeline
    if name == "synthetic_pose":
        from .synthetic_pose import SyntheticPosePipeline

        return SyntheticPosePipeline
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"the {name} benchmark is not ported yet (ROADMAP Queue 1 item 6)")
    raise ValueError(f"Unknown benchmark {name}")


def run_benchmark(benchmark: str, conf, experiment_dir: Path, model=None, device: Any = "cuda"):
    """Run a benchmark pipeline on `device` and return (summaries, figures);
    `model` (a state dict, e.g. of the model in training) overrides the
    checkpoint's entries."""
    experiment_dir = Path(experiment_dir)
    experiment_dir.mkdir(parents=True, exist_ok=True)
    pipeline = get_benchmark(benchmark)(conf, device=device)
    summaries, figures, _ = pipeline.run(experiment_dir, model=model, overwrite=True,
                                         overwrite_eval=True)
    return summaries, figures


__all__ = ["get_benchmark", "run_benchmark"]
