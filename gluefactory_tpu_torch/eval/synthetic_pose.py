"""Relative-pose benchmark on synthetic 3D multi-plane scenes (counterpart
of gluefactory_tpu/eval/synthetic_pose.py): the MegaDepth-1500 protocol
(export, then epipolar precision and the RANSAC pose errors, AUC at
5/10/20 degrees) on the test split of `synthetic_two_view`, reproducible
anywhere without downloaded data.

    python -m gluefactory_tpu_torch.eval.synthetic_pose [--conf FILE.json]
        [--checkpoint weights/hermetic/sp_open_lg_depth.npz] [--device cuda|cpu]
        [--overwrite] [--overwrite_eval] [key=value ...]

Writes to GLUEFACTORY_TPU_TORCH_EVAL/synthetic_pose/<tag>; prints the
summaries as JSON.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..datasets.synthetic_two_view import SyntheticTwoViewDataset
from ..settings import EVAL_PATH
from .io import get_eval_parser, parse_eval_args
from .relpose_benchmark import RelPoseBenchmarkPipeline


class SyntheticPosePipeline(RelPoseBenchmarkPipeline):
    default_conf = {
        "data": {
            "name": "synthetic_two_view",
            "image_size": [640, 480],
            "test_size": 20,
            "test_batch_size": 1,
        },
        "model": RelPoseBenchmarkPipeline.default_conf["model"],
        "eval": RelPoseBenchmarkPipeline.default_conf["eval"],
    }

    def make_dataset(self, data_conf):
        return SyntheticTwoViewDataset(data_conf)


def main(argv=None):
    args = get_eval_parser().parse_intermixed_args(argv)
    tag, conf = parse_eval_args("synthetic_pose", args, SyntheticPosePipeline.default_conf)
    pipeline = SyntheticPosePipeline(conf, device=args.device)
    summaries, _, _ = pipeline.run(Path(EVAL_PATH) / "synthetic_pose" / tag,
                                   overwrite=args.overwrite, overwrite_eval=args.overwrite_eval)
    print(json.dumps(summaries))
    return summaries


if __name__ == "__main__":
    main()
