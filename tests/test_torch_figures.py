"""The port's figures against the JAX package on the CPU, without
matplotlib in the port.

- The PNG encoder: grey and RGB images decode bit for bit by the port's
  decoder and by `matplotlib.image.imread`.
- `cm_RdGn` / `cm_ranking` equal the JAX functions.
- `make_match_figures`: the images, keypoints, match segments, colours and
  pens it hands to `viz2d` equal what the JAX function hands to its `viz2d`
  (recorded by patching the names in each package's `visualize_batch`
  module inside the test); its figures have both images side by side and
  the match lines drawn in their colours.
- The PR curve of `pr_curves`: the JAX trainer's `do_evaluation` (its
  data, model and mesh patched by the test) draws a line whose arrays equal
  the port's `pr_curve` and the port figure's, its AP equal.
- The trainer's hooks: `train.plot` and `pr_curves` write PNG figures that
  decode to the figure's size; a failing plot function is logged, training
  goes on.
"""

import logging

import matplotlib

matplotlib.use("Agg")
import matplotlib.image  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import gluefactory_tpu.visualization.visualize_batch as jax_vb  # noqa: E402
import gluefactory_tpu.visualization.viz2d as jax_viz  # noqa: E402
import gluefactory_tpu_torch.visualization.visualize_batch as vb  # noqa: E402
from gluefactory_tpu_torch.datasets.image_codecs import decode_png, encode_png  # noqa: E402
from gluefactory_tpu_torch.train.trainer import Trainer, pr_curve  # noqa: E402
from gluefactory_tpu_torch.utils.summary import ExperimentWriter  # noqa: E402
from gluefactory_tpu_torch.visualization import viz2d  # noqa: E402

MAKE = "gluefactory_tpu_torch.visualization.visualize_batch.make_match_figures"


# ------------------------------------------------------------------------ PNG
@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (1, 1), (64, 1, 3)])
def test_png_decodes_bit_for_bit(tmp_path, shape):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    data = encode_png(img)
    mode = "color" if img.ndim == 3 else "grey"
    np.testing.assert_array_equal(decode_png(data, mode=mode), img)
    (tmp_path / "x.png").write_bytes(data)
    ref = matplotlib.image.imread(tmp_path / "x.png")  # float in [0, 1]
    np.testing.assert_array_equal(np.round(ref * 255).astype(np.uint8), img)


def test_png_refuses_other_arrays():
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            encode_png(bad)


# ---------------------------------------------------------------- colour maps
def test_colour_maps_equal_jax():
    x = np.linspace(-0.5, 1.5, 41)
    np.testing.assert_array_equal(viz2d.cm_RdGn(x), jax_viz.cm_RdGn(x))
    sc = np.random.RandomState(0).rand(5000)
    assert viz2d.cm_ranking(sc) == jax_viz.cm_ranking(sc)
    assert viz2d.cm_ranking(sc[:9], ths=(2, 4)) == jax_viz.cm_ranking(sc[:9], ths=(2, 4))


# ------------------------------------------------------------- match figures
def _batch(seed=0, b=3, n=40, h=48, w=64):
    rng = np.random.RandomState(seed)
    kp = [rng.rand(b, n, 2).astype(np.float32) * (w, h) for _ in range(2)]
    m0 = rng.randint(-1, n, (b, n))
    m0[1] = -1  # a pair without a match
    gt = np.where(rng.rand(b, n) < 0.6, m0, rng.randint(-2, n, (b, n)))
    pred = {"keypoints0": kp[0], "keypoints1": kp[1], "matches0": m0}
    data = {"view0": {"image": rng.rand(b, h, w, 1).astype(np.float32)},
            "view1": {"image": rng.rand(b, h, w, 1).astype(np.float32)},
            "gt_matches0": gt}
    return pred, data


def _record(module, monkeypatch, real=None):
    """Patch `module`'s viz2d names to record their arguments (and call the
    real ones of `real`, if given)."""
    calls = []

    def recorder(name):
        def fn(*args, **kwargs):
            calls.append((name, args, kwargs))
            if real is not None:
                return getattr(real, name)(*args, **kwargs)
            return (name, ["ax0", "ax1"]) if name == "plot_images" else None
        return fn

    for name in ("plot_images", "plot_keypoints", "plot_matches"):
        monkeypatch.setattr(module, name, recorder(name))
    return calls


def _same(a, b, what):
    if isinstance(a, (list, tuple)) and not (a and np.isscalar(a[0])):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, str) or a is None:
        assert a == b, what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("gt", ["with gt", "without gt"])
def test_match_figures_draw_what_jax_draws(monkeypatch, gt):
    pred, data = _batch()
    if gt == "without gt":
        data.pop("gt_matches0")
    ref_calls = _record(jax_vb, monkeypatch)
    ref = jax_vb.make_match_figures(pred, data, n_pairs=3)
    calls = _record(vb, monkeypatch, real=viz2d)
    tpred = {k: torch.from_numpy(v) for k, v in pred.items()}
    tdata = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else torch.from_numpy(v)) for k, v in data.items()}
    figs = vb.make_match_figures(tpred, tdata, n_pairs=3)
    assert list(figs) == list(ref) == ["matching_0", "matching_1", "matching_2"]
    assert [c[0] for c in calls] == [c[0] for c in ref_calls]
    assert sum(c[0] == "plot_matches" for c in calls) == 2  # pair 1 has no match
    for (name, args, kwargs), (jname, jargs, jkwargs) in zip(calls, ref_calls):
        assert set(kwargs) == set(jkwargs), name
        if name != "plot_images":
            kwargs, jkwargs = {**kwargs, "axes": None}, {**jkwargs, "axes": None}
        _same(list(args), list(jargs), f"{name} args")
        for k in kwargs:
            _same(kwargs[k], jkwargs[k], f"{name} {k}")
    # the figures themselves: both images side by side, lines in their colours
    fig = figs["matching_0"]
    assert isinstance(fig, viz2d.Figure) and fig.shape == (48, 64 * 2 + 8, 3)
    canvas = fig.to_uint8()
    if gt == "with gt":
        colors = {tuple(c) for c in np.round(np.asarray(calls[2][2]["color"]) * 255)}
        assert {(0, 255, 0), (255, 0, 0)} <= colors
        # green and red match lines blend (a = 0.6) over the grey images
        g = (canvas[..., 1].astype(int) - canvas[..., 0] > 100).sum()
        r = (canvas[..., 0].astype(int) - canvas[..., 1] > 100).sum()
        assert g > 100 and r > 100, (g, r)


def test_segments_are_rasterised_along_their_line():
    fig = viz2d.Figure(20, 30)
    ax = viz2d.Axes(fig, 0, 0, 1.0)
    viz2d.plot_matches(np.array([[2.5, 2.5], [0.5, 15.5]]), np.array([[12.5, 12.5],
                                                                       [25.5, 15.5]]),
                       color=[(1, 0, 0), (0, 0, 1)], lw=1, ps=0, axes=(ax, ax))
    red = (fig.canvas == (1, 0, 0)).all(-1)
    blue = (fig.canvas == (0, 0, 1)).all(-1)
    assert [(y, x) for y, x in zip(*np.nonzero(red))] == [(i, i) for i in range(2, 13)]
    assert blue[15, 0:26].all() and blue.sum() == 26


# --------------------------------------------------------------- the PR curve
def test_pr_curve_equals_the_jax_trainers(monkeypatch):
    import gluefactory_tpu.train.trainer as jtr
    from gluefactory_tpu.utils.config import FrozenConfig

    rng = np.random.RandomState(4)
    batches = []
    for _ in range(3):
        m0 = rng.randint(-1, 30, (2, 30))
        gt = np.where(rng.rand(2, 30) < 0.5, m0, rng.randint(-2, 30, (2, 30)))
        scores = np.round(rng.rand(2, 30), 2).astype(np.float32)  # ties
        batches.append({"gt_matches0": gt, "matches0": m0, "matching_scores0": scores})

    class Writer:
        figures = []

        def figure(self, it, name, fig):
            line = fig.axes[0].lines[0]
            self.figures.append((name, line.get_xdata(), line.get_ydata()))

        def scalars(self, *a, **k):
            pass

    jt = object.__new__(jtr.Trainer)
    jt.conf = FrozenConfig({"train": {**jtr.default_train_conf, "pr_curves": True}})
    jt.dataset = type("D", (), {"get_data_loader": lambda self, split, epoch=0: batches})()
    jt.mesh, jt.state, jt.writer = None, None, Writer()
    jt.eval_fn = lambda state, batch: ({"total": np.zeros(2)}, {})
    jt.pred_fn = lambda state, batch: batch
    monkeypatch.setattr(jtr, "shard_batch", lambda batch, mesh, strict=True: batch)
    results = jt.do_evaluation(0, 7)
    (name, jrecall, jprecision), = Writer.figures
    assert name == "val/match_pr"

    labels = np.concatenate([(b["matches0"] == b["gt_matches0"])[(b["matches0"] >= 0)
                                                                 & (b["gt_matches0"] != -2)]
                             for b in batches])
    scores = np.concatenate([b["matching_scores0"][(b["matches0"] >= 0)
                                                   & (b["gt_matches0"] != -2)]
                             for b in batches])
    recall, precision, ap = pr_curve(labels, scores)
    np.testing.assert_array_equal(recall, jrecall)
    np.testing.assert_array_equal(precision, jprecision)
    assert ap == results["match_AP"]
    fig = viz2d.plot_curve(recall, precision)
    np.testing.assert_array_equal(fig.curves[0][0], jrecall)
    np.testing.assert_array_equal(fig.curves[0][1], jprecision)


# ---------------------------------------------------------- the trainer hooks
def _tiny_trainer_conf(plot):
    return {
        "data": {"name": "homographies", "synthetic": {"do": True, "pool": 4, "size": [160, 120]},
                 "train_size": 2, "val_size": 2, "train_batch_size": 2, "val_batch_size": 2,
                 "homography": {"patch_shape": [64, 48], "difficulty": 0.5}},
        "model": {"name": "two_view_pipeline",
                  "extractor": {"name": "superpoint_open", "max_num_keypoints": 32,
                                "detection_threshold": 0.0, "dtype": "float32",
                                "channels": [8, 8, 16, 16, 32], "descriptor_dim": 32},
                  "matcher": {"name": "lightglue", "n_layers": 1, "descriptor_dim": 32,
                              "input_dim": 32, "num_heads": 2, "is_training": True},
                  "ground_truth": {"name": "homography_matcher"}},
        "train": {"epochs": 1, "save_every_iter": -1, "log_every_iter": 1, "lr": 1e-4,
                  "eval_every_iter": -1, "pr_curves": True, "plot": plot},
    }


def test_trainer_writes_the_figures(tmp_path, monkeypatch, caplog):
    from gluefactory_tpu_torch.utils import experiments

    monkeypatch.setattr(experiments, "TRAINING_PATH", tmp_path)
    trainer = Trainer(_tiny_trainer_conf([2, MAKE]), "figs", tmp_path / "figs", device="cpu")
    trainer.build()
    trainer.train()
    figs = sorted(p.name for p in (tmp_path / "figs" / "figures").glob("*.png"))
    assert figs == ["matching_0_1.png", "matching_1_1.png", "val_match_pr_1.png"], figs
    img = decode_png((tmp_path / "figs" / "figures" / "matching_0_1.png").read_bytes())
    assert img.shape == (48, 2 * 64 + 8, 3)
    assert decode_png((tmp_path / "figs" / "figures" / "val_match_pr_1.png").read_bytes(),
                      mode="color").shape == (400, 400, 3)
    # a plot function that fails is logged; validation and training go on
    monkeypatch.setattr(vb, "make_match_figures", lambda *a, **k: 1 / 0)
    trainer.writer = ExperimentWriter(tmp_path / "again")  # train() closed its own
    with caplog.at_level(logging.WARNING):
        results = trainer.do_evaluation(0, 2)
    assert "plot hook failed" in caplog.text and "match_AP" in results


def test_writer_figure_names_and_pixels(tmp_path):
    fig = viz2d.plot_curve([0.0, 0.5, 1.0], [1.0, 0.5, 0.25])
    writer = ExperimentWriter(tmp_path)
    path = writer.figure(12, "val/match_pr", fig)
    writer.close()
    assert path == tmp_path / "figures" / "val_match_pr_12.png"
    np.testing.assert_array_equal(decode_png(path.read_bytes()), fig.to_uint8())
