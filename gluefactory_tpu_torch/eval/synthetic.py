"""Hermetic homography benchmark on procedural textures (counterpart of
gluefactory_tpu/eval/synthetic.py): the HPatches protocol (export, then
match precision, DLT and RANSAC H-AUC) on the synthetic homography
dataset's val split, reproducible anywhere without downloaded data.

    python -m gluefactory_tpu_torch.eval.synthetic [--conf FILE.json]
        [--checkpoint weights/hermetic/sp_open_lg.npz] [--device cuda|cpu]
        [--overwrite] [--overwrite_eval] [key=value ...]

Writes to GLUEFACTORY_TPU_TORCH_EVAL/synthetic/<tag>; prints the summaries
as JSON.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..datasets.homographies import HomographyDataset
from ..settings import EVAL_PATH
from .homography_benchmark import HomographyBenchmarkPipeline
from .io import get_eval_parser, parse_eval_args


class SyntheticHomographyPipeline(HomographyBenchmarkPipeline):
    default_conf = {
        "data": {
            "name": "homographies",
            "synthetic": {"do": True, "pool": 32, "size": [960, 720]},
            "train_size": 2,
            "val_size": 30,
            "test_batch_size": 1,
            "homography": {
                "difficulty": 0.5,
                "translation": 0.5,
                "max_angle": 30,
                "patch_shape": [640, 480],
            },
            "photometric": {"name": "lg", "p": 0.5},
        },
        "model": HomographyBenchmarkPipeline.default_conf["model"],
        "eval": HomographyBenchmarkPipeline.default_conf["eval"],
    }

    def make_dataset(self, data_conf):
        return HomographyDataset(data_conf)

    def get_dataloader(self, data_conf=None):
        dataset = self.make_dataset(data_conf or self.conf.data)
        return dataset.get_data_loader("val", shuffle=False)

    def get_eval_data(self):
        # the ground truth is drawn with the warps: the eval phase re-reads
        # the samples
        return self.get_dataloader()


def main(argv=None):
    args = get_eval_parser().parse_intermixed_args(argv)
    tag, conf = parse_eval_args("synthetic", args, SyntheticHomographyPipeline.default_conf)
    pipeline = SyntheticHomographyPipeline(conf, device=args.device)
    summaries, _, _ = pipeline.run(Path(EVAL_PATH) / "synthetic" / tag,
                                   overwrite=args.overwrite, overwrite_eval=args.overwrite_eval)
    print(json.dumps(summaries))
    return summaries


if __name__ == "__main__":
    main()
