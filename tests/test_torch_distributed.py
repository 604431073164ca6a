"""Training across processes in the port, on the CPU: two gloo ranks
against one process of the same configuration.

The file is also the ranks' program (`python tests/test_torch_distributed.py
RANK WORLD PORT OUT`): each rank reads torchrun's environment through
`train.distributed.init_distributed("gloo", "cpu")`, runs the scenarios
below and writes what it ends with under OUT. The one-process references
run in the test process. No JAX here: the reference is the port's own
one-process run, as the JAX package's tests/test_parallel.py holds its
two-process trainer against one process.

  - tests/test_parallel.py's tiny homography configuration (SuperPoint-open
    [8, 8, 16, 16, 32] from its seed, 24 keypoints, LightGlue 2 x 32, 8
    pairs of 96 x 80 in two steps of 4, lr 1e-3, one epoch with its
    validation and checkpoint), with the extractor in fp32 (its default
    bf16 is not what the JAX test's CPU run computes either), and stage 1
    of the hermetic loop (SuperPoint-open [8, 8, 16, 16, 32] with
    batch-mode BatchNorm, one step of 4 SyntheticShapes pairs at 48 x 64,
    validated one pair a batch: a batch the two ranks do not divide, which
    each evaluates whole):
    each step's gradient (the two ranks' all-reduced mean against the
    one-process gradient) within 1e-4 of its leaf's max|g| (the repository's
    gradient bar; of the model's for a leaf whose gradient is zero in exact
    arithmetic, below 1e-6 of the model's max|g|, and for every leaf after
    the first step, which starts from the parameters the exception below
    lets differ; measured up to 1.2e-5 of a leaf's max|g| through the
    batch-mode BatchNorms), the parameters within atol 1e-5 (the JAX test's
    bar), the running statistics within atol 1e-5, the logged losses and
    the validation's within rtol 1e-5. One exception, measured: an entry
    whose gradient is rounding noise (below 1e-6 of the model's max|g| in
    a step; zero in exact arithmetic, e.g. a bias that a batch-mode
    BatchNorm cancels, or the conditional encoding's phase, which the
    rotary attention cancels) takes Adam's step of lr times the sign of that
    noise, and the noise of a half-batch sum differs from the whole batch's:
    such entries moved by up to 2.4e-3 at lr 1e-3 (about lr per step in
    either run), and are held within 2 lr a step;
  - a non-finite batch on rank 1 alone: both ranks report
    `skipped_nonfinite` 1 and keep their parameters bit for bit;
plus the loader's shards (the ranks' slices, concatenated, are the
one-process batch), `--distributed` without torchrun's environment, and
`utils.stdout_capturing.capture_outputs`.
"""

import copy
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # run as the ranks' program
    sys.path.insert(0, str(ROOT))

import gluefactory_tpu_torch.utils.experiments as exps  # noqa: E402
from gluefactory_tpu_torch.datasets import get_dataset  # noqa: E402
from gluefactory_tpu_torch.train import distributed  # noqa: E402
from gluefactory_tpu_torch.train.trainer import Trainer  # noqa: E402
from gluefactory_tpu_torch.utils.config import load_conf, merge  # noqa: E402

HOMOGRAPHY = {
    "data": {"name": "homographies", "synthetic": {"do": True, "pool": 8, "size": [160, 120]},
             "train_size": 8, "val_size": 2, "train_batch_size": 4, "val_batch_size": 2,
             "num_workers": 0, "homography": {"patch_shape": [96, 80], "difficulty": 0.4}},
    "model": {"name": "two_view_pipeline",
              "extractor": {"name": "superpoint_open", "max_num_keypoints": 24,
                            "detection_threshold": 0.0, "channels": [8, 8, 16, 16, 32],
                            "descriptor_dim": 32, "trainable": False, "dtype": "float32"},
              "matcher": {"name": "lightglue", "n_layers": 2, "descriptor_dim": 32,
                          "input_dim": 32, "num_heads": 2, "is_training": True},
              "ground_truth": {"name": "homography_matcher", "th_positive": 3.0}},
    "train": {"seed": 0, "epochs": 1, "lr": 1e-3, "eval_every_iter": 1000,
              "save_every_iter": 1000, "log_every_iter": 1},
}
STAGE1 = {"data": {"length": 4, "val_length": 2, "image_size": [48, 64],
                   "generation_size": [96, 128], "train_batch_size": 4, "val_batch_size": 1,
                   "num_workers": 0},
          "model": {"channels": [8, 8, 16, 16, 32], "descriptor_dim": 32},
          "train": {"epochs": 1, "eval_every_iter": -1, "save_every_iter": -1,
                    "log_every_iter": 1}}


def stage1_conf():
    return merge(load_conf("superpoint-open_synthetic_pretrain"), STAGE1)


def run_scenarios(out: Path) -> None:
    """What every rank (and, with no process group, the one-process
    reference) runs; rank 0 writes the states, every rank its veto."""
    rank = distributed.rank()
    for name, conf in (("homography", HOMOGRAPHY), ("stage1", stage1_conf())):
        trainer = Trainer(conf, name, out / name if rank == 0 else None, device="cpu")
        trainer.build()
        opt, grads = trainer.state.optimizer, {}
        update = opt.update

        def record(gs, update=update, opt=opt, grads=grads):  # the step's reduced gradients
            grads.update({f"{opt.count}/{k}": g.numpy().copy() for k, g in zip(opt.names, gs)})
            update(gs)

        opt.update = record
        trainer.train()
        if rank == 0:
            state = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
            np.savez(out / f"{name}_state.npz", **state)
            np.savez(out / f"{name}_grads.npz", **grads)
    # the veto: rank 1's slice of the next batch is poisoned
    batch = next(iter(trainer.dataset.get_data_loader(
        "train", epoch=1, shard=(rank, distributed.world_size()))))
    if rank == 1:
        batch["image"][0, 5, 5, 0] = np.nan
    before = copy.deepcopy(trainer.model.state_dict())
    out_step = trainer.train_steps([batch])[0]
    kept = all(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    (out / f"veto_{rank}.json").write_text(json.dumps(
        {"skipped": out_step["skipped_nonfinite"], "kept": kept, "count":
         trainer.state.optimizer.count}))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scenarios on two gloo ranks (subprocesses) and in this process."""
    root = tmp_path_factory.mktemp("dist")
    port = _free_port()
    env = {**os.environ, "GLUEFACTORY_TPU_TORCH_TRAINING": str(root / "two" / "training"),
           "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    (root / "two").mkdir()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", str(port),
                               str(root / "two")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    (root / "one").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(exps, "TRAINING_PATH", root / "one" / "training")
        run_scenarios(root / "one")
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    return root


def _events(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("name,steps", [("homography", 2), ("stage1", 1)])
def test_two_processes_match_one(runs, name, steps):
    g2, g1 = (dict(np.load(runs / d / f"{name}_grads.npz")) for d in ("two", "one"))
    assert set(g2) == set(g1) and {k.split("/")[0] for k in g1} == {str(i) for i in range(steps)}
    top = max(np.abs(g).max() for g in g1.values())
    for k, g in g1.items():
        leaf = np.abs(g).max()
        # the first step starts from one state; a later one from parameters
        # whose rounding-noise entries differ (below)
        scale = leaf if k.startswith("0/") and leaf > 1e-6 * top else top
        np.testing.assert_allclose(g2[k], g, atol=1e-4 * scale, rtol=0, err_msg=k)
    two = np.load(runs / "two" / f"{name}_state.npz")
    one = np.load(runs / "one" / f"{name}_state.npz")
    assert set(two.files) == set(one.files)
    lr, noise = HOMOGRAPHY["train"]["lr"], 0
    for k in one.files:
        grads = [g1[f"{i}/{k}"] for i in range(steps) if f"{i}/{k}" in g1]
        rounding = np.zeros(one[k].shape, bool)
        for g in grads:  # entries whose gradient is rounding noise in a step
            rounding |= np.abs(g) <= 1e-6 * top
        diff = np.abs(two[k] - one[k])
        assert (diff[~rounding] <= 1e-5).all(), (k, diff[~rounding].max())
        assert (diff[rounding] <= 2 * lr * steps).all(), k
        noise += int(rounding.sum())
    # the exception stays an exception (3.9% of the entries at this size)
    assert noise < 0.05 * sum(v.size for v in one.values())
    if name == "stage1":  # the running statistics moved: the check above can fail
        assert not np.allclose(one["blocks.0.bn_var"], 1.0)
    ev2, ev1 = (_events(runs / d / name / "events.jsonl") for d in ("two", "one"))
    keys = [k for r in ev1 for k in r if k.startswith(("train/loss/", "val/loss/"))]
    assert {"train/loss/total", "val/loss/total"} <= set(keys)
    for k in set(keys):
        a = [r[k] for r in ev2 if k in r]
        b = [r[k] for r in ev1 if k in r]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=k)
    # rank 0 alone wrote the checkpoints
    assert (runs / "two" / "training" / name / "checkpoint_best" / "state.pt").exists()


def test_nonfinite_batch_on_one_rank_skips_every_rank(runs):
    vetos = [json.loads((runs / "two" / f"veto_{r}.json").read_text()) for r in range(2)]
    assert vetos == [{"skipped": 1.0, "kept": True, "count": 1}] * 2
    # in one process the same batch, unpoisoned, is a step
    one = json.loads((runs / "one" / "veto_0.json").read_text())
    assert one == {"skipped": 0.0, "kept": False, "count": 2}


def test_shards_are_slices_of_the_global_batch():
    ds = get_dataset("homographies")(HOMOGRAPHY["data"])
    whole = next(iter(ds.get_data_loader("train", epoch=3)))
    parts = [next(iter(ds.get_data_loader("train", epoch=3, shard=(r, 2)))) for r in range(2)]
    np.testing.assert_array_equal(np.concatenate([p["idx"] for p in parts]), whole["idx"])
    np.testing.assert_array_equal(
        np.concatenate([p["view1"]["image"] for p in parts]), whole["view1"]["image"])
    over = [next(iter(ds.get_overfit_loader("train", shard=(r, 2)))) for r in range(2)]
    np.testing.assert_array_equal(np.concatenate([p["idx"] for p in over]),
                                  next(iter(ds.get_overfit_loader("train")))["idx"])
    with pytest.raises(ValueError, match="not divisible by the 3 processes"):
        ds.get_data_loader("train", shard=(0, 3))


def test_distributed_without_torchrun_environment_raises(monkeypatch):
    from gluefactory_tpu_torch.train.__main__ import main

    for k in distributed.ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT"):
        main(["e", "--distributed", "--dist_backend", "gloo", "--device", "cpu"])
    assert not torch.distributed.is_initialized()


def test_capture_outputs_tees_and_restores(tmp_path, capsys):
    from gluefactory_tpu_torch.utils.stdout_capturing import capture_outputs

    out, err = sys.stdout, sys.stderr
    log = tmp_path / "logs" / "log.txt"
    with pytest.raises(KeyError):
        with capture_outputs(log):
            print("to both")
            print("error line", file=sys.stderr)
            raise KeyError("the streams come back on an error")
    assert sys.stdout is out and sys.stderr is err
    print("after")
    assert log.read_text() == "to both\nerror line\n"
    seen = capsys.readouterr()
    assert seen.out == "to both\nafter\n" and seen.err == "error line\n"


if __name__ == "__main__":
    rank_, world_, port_, out_ = sys.argv[1:5]
    torch.set_num_threads(1)
    os.environ.update(RANK=rank_, WORLD_SIZE=world_, LOCAL_RANK=rank_,
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port_)
    distributed.init_distributed("gloo", "cpu")
    try:
        run_scenarios(Path(out_))
    finally:
        torch.distributed.destroy_process_group()
