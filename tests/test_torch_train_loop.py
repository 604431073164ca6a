"""The port's training entry point against the JAX package on the CPU.

  - schedules: `exp` and `cosine` against optax's at counts 0, 1, steps / 2,
    steps and 2 steps, rel 1e-7 (both in float64);
  - the trainer: the JAX package's tiny configuration (48 keypoints,
    LightGlue 2 x 32 on a 32-wide input projection, 160 x 120 patches of a
    pool of 12 textures at 320 x 240), 16 pairs (two steps), through the
    JAX `Trainer` and the port's from the same initial parameters
    (`weights.params_from_jax`): each step's logged losses within rtol 1e-4
    / atol 1e-6, the gradient norms (`grad/norm`, `grad/norm/<module>`)
    within rel 1e-4, `val/loss/total` within rel 1e-4, the final parameters
    within 5e-4 (the bars of test_torch_train_step.py). One change to the
    tiny configuration: the extractor is the committed SuperPoint-open in
    fp32 (full width, grafted into the JAX trainer by its
    `train.load_experiment`), as in test_torch_train_step.py. The tiny
    configuration's randomly initialised detector scores every pixel about
    1/65, so its 48 keypoints are picked from near-ties that float rounding
    (XLA's convolutions against torch's) decides differently in the two
    packages;
  - the port alone: the summary records, the checkpoint layout and round
    trip, the interrupted checkpoint skipped, fine-tune grafting, resume
    equal to an uninterrupted run (bitwise on the CPU), and the command line
    in a subprocess.
"""

import copy
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen
import gluefactory_tpu.settings as jax_settings
import gluefactory_tpu.utils.experiments as jax_exps
import gluefactory_tpu_torch.utils.experiments as exps
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.models.matchers.lightglue_pretrained import load_npz_params
from gluefactory_tpu.train.trainer import Trainer as JaxTrainer
from gluefactory_tpu_torch.train.step import make_schedule
from gluefactory_tpu_torch.train.trainer import Trainer
from gluefactory_tpu_torch.utils.experiments import (
    get_best_checkpoint,
    get_last_checkpoint,
    load_checkpoint,
    save_experiment,
)
from gluefactory_tpu_torch.utils.config import merge
from gluefactory_tpu_torch.weights import HERMETIC, params_from_jax, params_to_jax

ROOT = Path(__file__).resolve().parent.parent
EXTRACTOR = {"name": "superpoint_open", "max_num_keypoints": 48, "detection_threshold": 0.0,
             "trainable": False, "dtype": "float32"}
MATCHER = {"name": "lightglue", "n_layers": 2, "descriptor_dim": 32, "input_dim": 256,
           "num_heads": 2}
SYNTH = {"do": True, "pool": 12, "size": [320, 240]}


def tiny_conf(train_size=16, epochs=1):
    """tests/test_train.py's tiny configuration without `plot` (its figure
    hook needs matplotlib), with `train_size` pairs and the full-width fp32
    extractor."""
    return {
        "data": {"name": "homographies", "synthetic": SYNTH, "train_size": train_size,
                 "val_size": 2, "train_batch_size": 8, "val_batch_size": 2,
                 "homography": {"patch_shape": [160, 120], "difficulty": 0.5}},
        "model": {"name": "two_view_pipeline", "extractor": EXTRACTOR,
                  "matcher": {**MATCHER, "is_training": True},
                  "ground_truth": {"name": "homography_matcher"}},
        "train": {"epochs": epochs, "save_every_iter": -1, "log_every_iter": 1,
                  "log_grad_every_iter": 1, "pr_curves": True, "eval_every_iter": -1,
                  "lr": 1e-4},
    }


def events(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def series(records: list, key: str) -> list:
    return [r[key] for r in records if key in r]


# ------------------------------------------------------------------ schedules
@pytest.mark.parametrize("stype", ["exp", "cosine"])
def test_schedule_matches_optax(stype):
    lr, steps = 3e-4, 1000
    conf = {"lr": lr, "lr_schedule": {"type": stype, "start": 100, "exp_div_10": 400,
                                      "steps": steps}}
    counts = [0, 1, steps // 2, steps, 2 * steps]
    with jax.enable_x64(True):
        if stype == "cosine":
            ref = optax.cosine_decay_schedule(lr, steps)
        else:  # the JAX package's make_optimizer, float64
            ref = lambda i: lr * jnp.power(10.0, -jnp.maximum(i - 100, 0) / 400)
        expect = [float(ref(jnp.asarray(c, jnp.int64))) for c in counts]
    sched = make_schedule(conf)
    got = [sched(c) for c in counts]
    np.testing.assert_allclose(got, expect, rtol=1e-7, atol=0)
    assert got[0] == lr


# -------------------------------------------------------------- the trainers
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One epoch of two steps through the JAX Trainer and the port's, from
    the same initial parameters."""
    root = tmp_path_factory.mktemp("train")
    conf = tiny_conf()
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_settings, jax_exps):
            mp.setattr(mod, "TRAINING_PATH", root / "jax")
        # the JAX trainer initialises its model eagerly, op by op (half a
        # minute on the CPU); the same init under jit takes seconds
        pipeline = type(jax_model(conf["model"]["name"]).from_conf(conf["model"]))
        mp.setattr(pipeline, "init", lambda self, *a, **k: jax.jit(
            functools.partial(flax.linen.Module.init, self))(*a, **k))
        hermetic = jax.tree.map(lambda a: np.asarray(a, np.float32), load_npz_params(HERMETIC))
        jax_exps.save_experiment("sp", {c: {"extractor": hermetic[c]["extractor"]}
                                        for c in ("params", "batch_stats")},
                                 {}, epoch=0, iter_i=0, is_best=True)
        # (its PR curve, a figure, only adds a compile: nothing compared)
        jt = JaxTrainer(merge(conf, {"train": {"load_experiment": "sp", "pr_curves": False}}),
                        "exp", root / "jax" / "exp")
        jt.build()
        init = params_from_jax(jax.tree.map(np.asarray, {"params": jt.state.params,
                                                          "batch_stats": jt.state.batch_stats}))
        jt.train()
        jax_params = jax.tree.map(np.asarray, jt.state.params)
    exps_root = root / "port"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(exps, "TRAINING_PATH", exps_root)
        pt = Trainer(conf, "exp", exps_root / "exp", device="cpu")
        pt.build()
        pt.load_weights(init)
        pt.train()
    return {"jax": events(root / "jax" / "exp" / "events.jsonl"), "jax_params": jax_params,
            "port": events(exps_root / "exp" / "events.jsonl"), "trainer": pt, "init": init,
            "root": exps_root}


LOSS_KEYS = ["total", "last", "assignment_nll", "nll_pos", "nll_neg", "num_matchable",
             "num_unmatchable", "row_norm", "confidence", "skipped_nonfinite"]


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_trainer_losses_match_jax(runs, key):
    ref = series(runs["jax"], f"train/loss/{key}")
    got = series(runs["port"], f"train/loss/{key}")
    assert len(ref) == len(got) == 2
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6, err_msg=key)
    if key == "num_matchable":
        assert min(ref) > 3


@pytest.mark.parametrize("key", ["grad/norm", "grad/norm/matcher", "grad/norm/extractor"])
def test_gradient_norms_match_jax(runs, key):
    """The JAX trainer's norms come from `make_train_step(grad_stats=True)`."""
    ref = series(runs["jax"], f"train/{key}")
    got = series(runs["port"], f"train/{key}")
    assert len(ref) == len(got) == 2
    if key == "grad/norm/extractor":  # frozen
        assert ref == got == [0.0, 0.0]
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0)


def test_validation_loss_matches_jax(runs):
    ref, got = series(runs["jax"], "val/loss/total"), series(runs["port"], "val/loss/total")
    assert len(ref) == len(got) == 1
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_final_parameters_match_jax(runs):
    tree = params_to_jax(runs["trainer"].model.state_dict())["params"]
    ref = runs["jax_params"]
    for comp in ("matcher", "extractor"):
        for path, want in jax.tree_util.tree_leaves_with_path(ref[comp]):
            have = tree[comp]
            for p in path:
                have = have[p.key]
            assert have.shape == want.shape, path
            np.testing.assert_allclose(have, want, atol=5e-4, rtol=0, err_msg=str(path))


def test_summary_records(runs):
    """The events the JAX test_train_and_checkpoint_roundtrip asserts,
    figures excepted."""
    keys = {k for r in runs["port"] for k in r}
    assert {"train/loss/total", "train/grad/norm", "train/grad/norm/matcher",
            "train/grad/module_norms__hist", "val/match_AP", "val/loss/total"} <= keys
    hist = next(r["train/grad/module_norms__hist"] for r in runs["port"]
                if "train/grad/module_norms__hist" in r)
    assert set(hist) == {"counts", "edges", "mean", "max"} and sum(hist["counts"]) == 2


def test_checkpoint_layout_and_round_trip(runs):
    root, trainer = runs["root"], runs["trainer"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(exps, "TRAINING_PATH", root)
        last, best = get_last_checkpoint("exp"), get_best_checkpoint("exp")
    assert last.name == "checkpoint_0_2"
    for path in (last, best):
        state, meta = load_checkpoint(path)
        assert meta["epoch"] == 0 and meta["iter"] == 2 and state["step"] == 2
        assert meta["conf"]["train"]["lr"] == 1e-4 and "loss/total" in meta["eval"]
        assert meta["best_eval"] == pytest.approx(meta["eval"]["loss/total"])
        assert state["optimizer"]["count"] == 2
        for k, v in trainer.model.state_dict().items():
            assert torch.equal(state["model"][k], v), k
    assert (root / "exp" / "source" / "gluefactory_tpu_torch" / "train" / "trainer.py").exists()
    assert json.loads((root / "exp" / "config.json").read_text())["model"]["matcher"]["n_layers"] == 2


def test_interrupted_checkpoint_is_skipped_and_old_ones_pruned(tmp_path, monkeypatch):
    monkeypatch.setattr(exps, "TRAINING_PATH", tmp_path)
    state = {"step": 1, "model": {"w": torch.ones(2, 2)}}
    for it in (10, 20, 30):
        save_experiment("e", state, {}, epoch=0, iter_i=it, num_keep=2)
    save_experiment("e", state, {}, epoch=0, iter_i=40, interrupted=True, num_keep=2)
    assert get_last_checkpoint("e").name == "checkpoint_0_30"
    names = sorted(p.name for p in (tmp_path / "e").iterdir())
    assert names == ["checkpoint_0_20", "checkpoint_0_30", "checkpoint_0_40_interrupted",
                     "conf.json"]


def test_load_experiment_grafts_matching_tensors(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(exps, "TRAINING_PATH", tmp_path)
    src = {k: v + 1.0 for k, v in runs["init"].items()}
    src["matcher.assign_proj_w"] = torch.zeros(3, 3)  # a shape that does not fit stays fresh
    save_experiment("src", {"model": src}, {}, epoch=0, iter_i=1, is_best=True)
    conf = tiny_conf()
    conf["train"]["load_experiment"] = "src"
    trainer = Trainer(conf, "dst", None, device="cpu")
    fresh = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.build()
    for k, v in trainer.model.state_dict().items():
        want = fresh[k] if k == "matcher.assign_proj_w" else src[k]
        assert torch.equal(v, want.to(v.dtype)), k


def test_load_experiment_prefix_grafts_a_submodule(runs, tmp_path, monkeypatch):
    """`load_experiment_prefix` seeds one module of the model from the
    checkpoint of that module alone."""
    monkeypatch.setattr(exps, "TRAINING_PATH", tmp_path)
    extractor = {k.split(".", 1)[1]: v * 2.0 for k, v in runs["init"].items()
                 if k.startswith("extractor.")}
    save_experiment("sp", {"model": extractor}, {}, epoch=0, iter_i=1, is_best=True)
    conf = tiny_conf()
    conf["train"].update(load_experiment="sp", load_experiment_prefix="extractor")
    trainer = Trainer(conf, "dst", None, device="cpu")
    matcher = {k: v.clone() for k, v in trainer.model.state_dict().items()
               if k.startswith("matcher.")}
    trainer.build()
    for k, v in trainer.model.state_dict().items():
        want = extractor[k.split(".", 1)[1]] if k.startswith("extractor.") else matcher[k]
        assert torch.equal(v, want.to(v.dtype)), k


def test_resume_equals_uninterrupted(runs, tmp_path, monkeypatch):
    """Epoch 0 (the fixture's run), a restore, then epoch 1, against both
    epochs in one run: bitwise equal parameters, Adam moments and count."""
    monkeypatch.setattr(exps, "TRAINING_PATH", runs["root"])
    resumed = Trainer(tiny_conf(epochs=2), "exp", None, device="cpu")
    resumed.build(restore=True)
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    resumed.train()

    monkeypatch.setattr(exps, "TRAINING_PATH", tmp_path)
    straight = Trainer(tiny_conf(epochs=2), "exp", None, device="cpu")
    straight.build()
    straight.load_weights(runs["init"])
    straight.train()
    assert resumed.state.step == straight.state.step == 4
    a, b = resumed.checkpoint_state(), straight.checkpoint_state()
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 4
    for kind in ("mu", "nu"):
        for k, v in b["optimizer"][kind].items():
            assert torch.equal(a["optimizer"][kind][k], v), (kind, k)


def test_options_not_ported_raise(monkeypatch):
    conf = copy.deepcopy(tiny_conf())
    conf["train"]["plot"] = [1, "gluefactory_tpu.visualization.visualize_batch.make_match_figures"]
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        Trainer(conf, "e", None, device="cpu")
    from gluefactory_tpu_torch.eval import get_benchmark
    from gluefactory_tpu_torch.train.__main__ import main

    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        get_benchmark("megadepth1500")
    # --distributed is ported: without torchrun's environment it raises, naming it
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR"):
        main(["e", "--distributed"])


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tiny_conf(), "e")


def _cli(args, env):
    out = subprocess.run([sys.executable, "-m", "gluefactory_tpu_torch.train", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_command_line_on_the_cpu(tmp_path):
    """`python -m gluefactory_tpu_torch.train` on the training configuration
    cut to the tiny sizes: an epoch with validation, checkpoints and the
    synthetic benchmark, then --restore for the second."""
    env = {**os.environ, "OMP_NUM_THREADS": "2", "GLUEFACTORY_TPU_TORCH_TRAINING": str(tmp_path),
           "PYTHONPATH": str(ROOT)}
    bench = {"data": {"val_size": 2, "synthetic": {"pool": 4, "size": [320, 240]},
                      "homography": {"patch_shape": [160, 120]}},
             "model": {"extractor": EXTRACTOR, "matcher": MATCHER}}
    args = ["exp", "--conf", "superpoint-open+lightglue_homography", "--device", "cpu",
            f"data.synthetic={json.dumps(SYNTH)}", "data.batch_size=null",
            "data.train_batch_size=8", "data.val_batch_size=2", "data.train_size=8",
            "data.val_size=2", "data.homography.patch_shape=[160,120]",
            f"model.extractor={json.dumps(EXTRACTOR)}", f"model.matcher={json.dumps(MATCHER)}",
            "train.epochs=1", "train.log_every_iter=1", "train.eval_every_iter=-1",
            f"train.benchmarks={json.dumps({'synthetic': bench})}"]
    _cli(args, env)
    exp = tmp_path / "exp"
    assert (exp / "checkpoint_0_1" / "meta.json").exists() and (exp / "checkpoint_best").exists()
    summaries = json.loads((exp / "benchmarks" / "synthetic" / "summaries.json").read_text())
    assert "H_error_dlt@3px" in summaries and "mnum_keypoints" in summaries
    _cli([*args[:-2], "--restore", "train.epochs=2", "train.benchmarks=null"], env)
    assert sorted(p.name for p in exp.glob("checkpoint_*_*")) == ["checkpoint_0_1",
                                                                   "checkpoint_1_2"]
    records = events(exp / "events.jsonl")
    assert series(records, "train/loss/total") and len(series(records, "val/loss/total")) == 2


def test_profile_and_interrupt(tmp_path, monkeypatch):
    """`profile` traces the steps [profile_start, profile_end) into
    <output_dir>/profile; a stop request (SIGINT) ends the epoch after the
    step with an `_interrupted` checkpoint that --restore skips."""
    monkeypatch.setattr(exps, "TRAINING_PATH", tmp_path)
    conf = tiny_conf(train_size=16)
    conf["train"].update(profile=True, profile_start=0, profile_end=1)
    trainer = Trainer(conf, "p", tmp_path / "p", device="cpu")
    trainer.build()
    trainer.stop_requested = True
    trainer.train()
    assert trainer.state.step == 1
    assert (tmp_path / "p" / "profile" / "trace.json").stat().st_size > 0
    assert (tmp_path / "p" / "checkpoint_0_1_interrupted" / "state.pt").exists()
    with pytest.raises(FileNotFoundError):
        get_last_checkpoint("p")
