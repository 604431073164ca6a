"""HPatches homography benchmark (counterpart of
gluefactory_tpu/eval/hpatches.py):

    python -m gluefactory_tpu_torch.eval.hpatches [--conf FILE.json]
        [--checkpoint weights/hermetic/sp_open_lg.npz] [--device cuda|cpu]
        [--overwrite] [--overwrite_eval] [key=value ...]

Images are resized to 480 on the short side and padded to a fixed 864 x 480
box; H-AUC at 1/3/5 px through the weighted DLT and a RANSAC threshold
sweep. Reads GLUEFACTORY_TPU_TORCH_DATA/hpatches-sequences-release and
writes to GLUEFACTORY_TPU_TORCH_EVAL/hpatches/<tag>; prints the summaries
as JSON.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..datasets.hpatches import HPatchesDataset
from ..settings import EVAL_PATH
from .homography_benchmark import HomographyBenchmarkPipeline
from .io import get_eval_parser, parse_eval_args


class HPatchesPipeline(HomographyBenchmarkPipeline):
    default_conf = {
        "data": {
            "name": "hpatches",
            "preprocessing": {
                "resize": 480,
                "side": "short",
                # HPatches' aspect ratios fit 864 x 480 after the resize
                "pad_to": [864, 480],
            },
            "test_batch_size": 1,
        },
        "model": HomographyBenchmarkPipeline.default_conf["model"],
        "eval": HomographyBenchmarkPipeline.default_conf["eval"],
    }

    def make_dataset(self, data_conf):
        return HPatchesDataset(data_conf)


def main(argv=None):
    args = get_eval_parser().parse_intermixed_args(argv)
    tag, conf = parse_eval_args("hpatches", args, HPatchesPipeline.default_conf)
    pipeline = HPatchesPipeline(conf, device=args.device)
    summaries, _, _ = pipeline.run(Path(EVAL_PATH) / "hpatches" / tag, overwrite=args.overwrite,
                                   overwrite_eval=args.overwrite_eval)
    print(json.dumps(summaries))
    return summaries


if __name__ == "__main__":
    main()
