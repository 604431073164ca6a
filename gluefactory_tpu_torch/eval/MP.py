"""Multispectral (optical <-> thermal) homography benchmark (counterpart of
gluefactory_tpu/eval/MP.py): the HPatches protocol (export, then match
precision, DLT and RANSAC H-AUC at 1/3/5 px) on the test split of the MP
pair dataset, view0 optical and view1 thermal.

    python -m gluefactory_tpu_torch.eval.MP [--conf FILE.json]
        [--checkpoint FILE.npz] [--device cuda|cpu]
        [--overwrite] [--overwrite_eval] [key=value ...]

The default configuration is the JAX module's, whose `sift` extractor is the
host OpenCV SIFT, which is not portable: it raises; give an extractor
(`sift_tpu` is the DoG SIFT on the device), e.g.
`--conf gluefactory_tpu_torch/configs/superpoint-open+lightglue_MP.json
--checkpoint weights/hermetic/sp_open_lg.npz`. Writes to
GLUEFACTORY_TPU_TORCH_EVAL/MP/<tag>; prints the summaries as JSON.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..datasets.mp_image_pairs import MPImagePairs
from ..settings import EVAL_PATH
from .homography_benchmark import HomographyBenchmarkPipeline
from .io import get_eval_parser, parse_eval_args


class MPPipeline(HomographyBenchmarkPipeline):
    default_conf = {
        "data": {
            "name": "mp_image_pairs",
            "mp": {
                "filename": None,  # synthetic pairs
                "augmentation": {
                    "photometric": {"enable": False},
                    "homographic": {
                        "enable": True,
                        "params": {"difficulty": 0.4, "translation": 0.3, "max_angle": 25},
                    },
                },
            },
            "test_batch_size": 1,
        },
        "model": {
            "name": "two_view_pipeline",
            "extractor": {"name": "sift", "max_num_keypoints": 1024},
            "matcher": {"name": "nearest_neighbor_matcher", "ratio_thresh": 0.95},
        },
        "eval": HomographyBenchmarkPipeline.default_conf["eval"],
    }

    def make_dataset(self, data_conf):
        return MPImagePairs(data_conf)

    def get_eval_data(self):
        # the ground truth is drawn with the warps: the eval phase re-reads
        # the samples
        return self.get_dataloader()


def main(argv=None):
    args = get_eval_parser().parse_intermixed_args(argv)
    tag, conf = parse_eval_args("MP", args, MPPipeline.default_conf)
    pipeline = MPPipeline(conf, device=args.device)
    summaries, _, _ = pipeline.run(Path(EVAL_PATH) / "MP" / tag, overwrite=args.overwrite,
                                   overwrite_eval=args.overwrite_eval)
    print(json.dumps(summaries))
    return summaries


if __name__ == "__main__":
    main()
