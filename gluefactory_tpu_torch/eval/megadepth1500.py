"""MegaDepth-1500 relative-pose benchmark (counterpart of
gluefactory_tpu/eval/megadepth1500.py): the 1500 calibrated pairs of
`pairs_calibrated.txt` through `ImagePairs`, each image resized to 1600 on
its long side and padded to 1600 x 1600; export, then the epipolar precision
and the RANSAC pose errors, AUC at 5/10/20 degrees (`RelPoseBenchmarkPipeline`).

    python -m gluefactory_tpu_torch.eval.megadepth1500 [--conf FILE.json]
        [--checkpoint weights/hermetic/sp_open_lg.npz] [--device cuda|cpu]
        [--overwrite] [--overwrite_eval] [key=value ...]

Reads GLUEFACTORY_TPU_TORCH_DATA/megadepth1500/{images/, pairs_calibrated.txt}
(nothing is downloaded) and writes to
GLUEFACTORY_TPU_TORCH_EVAL/megadepth1500/<tag>; prints the summaries as
JSON. The eval phase reads the image headers only.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..datasets.base_dataset import collate
from ..datasets.image_pairs import ImagePairs
from ..settings import EVAL_PATH
from .io import get_eval_parser, parse_eval_args
from .relpose_benchmark import RelPoseBenchmarkPipeline


class MegaDepth1500Pipeline(RelPoseBenchmarkPipeline):
    default_conf = {
        "data": {
            "name": "image_pairs",
            "pairs": "megadepth1500/pairs_calibrated.txt",
            "root": "megadepth1500/images/",
            "preprocessing": {
                "resize": 1600,
                "side": "long",
                "pad_to": [1600, 1600],
            },
            "test_batch_size": 1,
        },
        "model": RelPoseBenchmarkPipeline.default_conf["model"],
        "eval": RelPoseBenchmarkPipeline.default_conf["eval"],
    }

    def make_dataset(self, data_conf):
        return ImagePairs(data_conf)

    def get_eval_data(self):
        """One pair's cameras, pose and image sizes at a time, from the image
        headers: the eval phase needs no pixels."""
        split = self.make_dataset(self.conf.data).get_dataset("test")
        return (collate([split.metadata(i)]) for i in range(len(split)))


def main(argv=None):
    args = get_eval_parser().parse_intermixed_args(argv)
    tag, conf = parse_eval_args("megadepth1500", args, MegaDepth1500Pipeline.default_conf)
    pipeline = MegaDepth1500Pipeline(conf, device=args.device)
    summaries, _, _ = pipeline.run(Path(EVAL_PATH) / "megadepth1500" / tag,
                                   overwrite=args.overwrite, overwrite_eval=args.overwrite_eval)
    print(json.dumps(summaries))
    return summaries


if __name__ == "__main__":
    main()
