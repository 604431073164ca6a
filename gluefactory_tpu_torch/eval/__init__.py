"""Benchmarks of the port (counterpart of gluefactory_tpu/eval): the
registry and the hook the trainer calls at the end of an epoch. All the JAX
package's benchmarks are ported: HPatches (`eval.hpatches`), MegaDepth-1500
(`eval.megadepth1500`), ETH3D (`eval.eth3d`), the synthetic homography and
relative-pose benchmarks (`eval.synthetic`, `eval.synthetic_pose`) and the
multispectral benchmark (`eval.MP`)."""

from __future__ import annotations

from pathlib import Path
from typing import Any

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
    if name == "MP":
        from .MP import MPPipeline

        return MPPipeline
    if name == "megadepth1500":
        from .megadepth1500 import MegaDepth1500Pipeline

        return MegaDepth1500Pipeline
    if name == "eth3d":
        from .eth3d import ETH3DPipeline

        return ETH3DPipeline
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
