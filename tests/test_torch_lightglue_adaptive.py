"""LightGlue's adaptive inference (early exit on token confidence, width
pruning with the compact second phase) of the port against the JAX model on
the CPU, in fp32 unless said, with the JAX model's random initialisation
carried across through weights.params_from_jax.

The cases follow the JAX package's own (tests/test_models.py: no exit fires,
a confident exit at layer 0, compact against mask-only pruning;
tests/test_pallas_lightglue_block.py: the adaptive loop through the block
kernels). Bars in fp32: `stop_layer`, `prune0`, `prune1` equal, `matches0`
equal on at least 99% of entries, `log_assignment` within 1e-4 where it is
compared.

Where the loop ends (an exit, or the last layer) before every active set
fits the capacity C, the JAX model's code gathers the first C active tokens
of each set all the same and drops the rest from the exit assignment,
though its configuration comment says no token is ever dropped. The port
reproduces the code's result: at the default `width_capacity` the two are
held equal in that case too, and with `width_capacity: -1` both keep every
active token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.models.matchers.lightglue_pretrained import load_npz_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.weights import HERMETIC, load_hermetic, params_from_jax

BASE = {"n_layers": 3, "descriptor_dim": 64, "input_dim": 64, "num_heads": 2}


def _data(seed, b, m, n, d=64, masked=False):
    rng = np.random.RandomState(seed)
    data = {
        "keypoints0": (rng.rand(b, m, 2) * 400).astype(np.float32),
        "keypoints1": (rng.rand(b, n, 2) * 400).astype(np.float32),
        "descriptors0": rng.randn(b, m, d).astype(np.float32),
        "descriptors1": rng.randn(b, n, d).astype(np.float32),
        "view0": {"image_size": np.full((b, 2), 400.0, np.float32)},
        "view1": {"image_size": np.full((b, 2), 400.0, np.float32)},
    }
    if masked:
        m0, m1 = np.ones((b, m), bool), np.ones((b, n), bool)
        m0[:, -m // 4:] = False
        m1[0, -n // 3:] = False
        data["keypoint_mask0"], data["keypoint_mask1"] = m0, m1
    return data


def _convert(data, fn):
    return {k: _convert(v, fn) if isinstance(v, dict) else fn(v) for k, v in data.items()}


_torch = lambda data: _convert(data, lambda a: torch.from_numpy(np.array(a)))


def _init(data, tweak=None, base=BASE):
    """The JAX model's seeded variables, with one parameter overwritten."""
    jm = jax_model("lightglue").from_conf(base)
    variables = jm.init(jax.random.PRNGKey(0), _convert(data, jnp.asarray))
    if tweak:
        params = dict(variables["params"])
        params[tweak[0]] = jnp.full_like(params[tweak[0]], tweak[1])
        variables = {"params": params}
    return variables


def _port(conf, variables, base=BASE):
    tm = get_model("lightglue")({**base, **conf}, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    return tm


def _jax(conf, variables, data, base=BASE):
    out = jax_model("lightglue").from_conf({**base, **conf}).apply(
        variables, _convert(data, jnp.asarray))
    return jax.tree.map(np.asarray, out)


CONFIDENT = ("conf_head_b", 10.0)      # every token confident: exit at layer 0
UNMATCHABLE = ("assign_match_b", -1.5)  # a real share of tokens falls under the keep threshold
ALIVE = 4.0  # prune count of a token that stayed active through all 3 layers (1 + 3)
SHAPES = [(32, 32, False), (32, 24, True)]


# --------------------------------------------------------- the port on its own
@pytest.mark.parametrize("m,n,masked", SHAPES)
def test_no_exit_equals_full_depth(m, n, masked):
    """An unreachable depth_confidence runs every layer: the loop may change
    when to stop, never the layers' arithmetic."""
    data = _data(1, 2, m, n, masked=masked)
    variables = _init(data)
    full = _port({}, variables)(_torch(data))
    adapt = _port({"depth_confidence": 0.999999}, variables)(_torch(data))
    assert int(adapt["stop_layer"]) == 2
    assert torch.equal(adapt["matches0"], full["matches0"])
    torch.testing.assert_close(adapt["log_assignment"], full["log_assignment"], atol=1e-4, rtol=0)
    assert adapt["ref_descriptors0"].shape == (2, 1, m, 64)
    assert torch.equal(adapt["prune0"], torch.ones(2, m))  # counted only when pruning is on


@pytest.mark.parametrize("m,n,masked", SHAPES)
def test_confident_exit_matches_one_layer_model(m, n, masked):
    data = _data(2, 2, m, n, masked=masked)
    variables = _init(data, CONFIDENT)
    adapt = _port({"depth_confidence": 0.95}, variables)(_torch(data))
    assert int(adapt["stop_layer"]) == 0
    stacked = ("self_", "cross_", "assign_", "conf_head")
    first = {"params": {k: (v[:1] if k.startswith(stacked) else v)
                        for k, v in variables["params"].items()}}
    one = _port({"n_layers": 1}, first)(_torch(data))
    assert torch.equal(adapt["matches0"], one["matches0"])
    torch.testing.assert_close(adapt["matching_scores0"], one["matching_scores0"],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("m,n,masked", SHAPES)
def test_compact_pruning_equals_mask_only(m, n, masked):
    data = _data(3, 2, m, n, masked=masked)
    variables = _init(data, UNMATCHABLE)
    conf = {"width_confidence": 0.8}
    masked_only = _port({**conf, "width_capacity": -1}, variables)(_torch(data))
    compact = _port({**conf, "width_capacity": 0.5}, variables)(_torch(data))
    assert bool((masked_only["prune0"] < ALIVE).any()), "pruning never fired"
    for key in ("matches0", "matches1", "prune0", "prune1"):
        assert torch.equal(compact[key], masked_only[key]), key
    torch.testing.assert_close(compact["matching_scores0"], masked_only["matching_scores0"],
                               atol=1e-5, rtol=0)
    assert int(compact["stop_layer"]) == int(masked_only["stop_layer"])
    # a pruned keypoint is never matched
    assert bool((compact["matches0"][compact["prune0"] < ALIVE] == -1).all())


def test_resolve_capacity_and_thresholds():
    model = get_model("lightglue")({**BASE, "n_layers": 9, "width_confidence": 0.99}, device="cpu")
    assert [model._resolve_capacity(k) for k in (1024, 256, 200, 128, 32, 8)] == [
        512, 128, 104, 64, 16, 0]
    schedule = np.clip(0.8 + 0.1 * np.exp(-4.0 * np.arange(9) / 9), 0.0, 1.0).astype(np.float32)
    np.testing.assert_array_equal(np.float32(model.confidence_thresholds), schedule)
    off = get_model("lightglue")({**BASE, "width_confidence": 0.99, "width_capacity": -1},
                                 device="cpu")
    assert off._resolve_capacity(1024) == 0
    absolute = get_model("lightglue")({**BASE, "width_confidence": 0.99, "width_capacity": 300},
                                      device="cpu")
    assert absolute._resolve_capacity(1024) == 384


# -------------------------------------------------------- against the JAX model
def _hold(out, ref, masks=None, la_atol=None):
    assert int(out["stop_layer"]) == int(ref["stop_layer"])
    np.testing.assert_array_equal(out["prune0"].numpy(), ref["prune0"])
    np.testing.assert_array_equal(out["prune1"].numpy(), ref["prune1"])
    assert (out["matches0"].numpy() == ref["matches0"]).mean() >= 0.99
    assert (out["matches1"].numpy() == ref["matches1"]).mean() >= 0.99
    if la_atol is not None:
        np.testing.assert_allclose(out["log_assignment"].numpy(), ref["log_assignment"],
                                   atol=la_atol)


@pytest.mark.parametrize("m,n,masked", SHAPES)
@pytest.mark.parametrize("case,conf,tweak", [
    ("no_exit", {"depth_confidence": 0.999999}, None),
    ("exit_at_0", {"depth_confidence": 0.95}, CONFIDENT),
    ("prune_compact", {"width_confidence": 0.8, "width_capacity": 0.5}, UNMATCHABLE),
    ("prune_mask_only", {"width_confidence": 0.8, "width_capacity": -1}, UNMATCHABLE),
    ("depth_and_width_prune", {"depth_confidence": 0.95, "width_confidence": 0.8,
                               "width_capacity": -1}, UNMATCHABLE),
])
def test_adaptive_matches_jax(case, conf, tweak, m, n, masked):
    data = _data(4, 2, m, n, masked=masked)
    variables = _init(data, tweak)
    out = _port(conf, variables)(_torch(data))
    ref = _jax(conf, variables, data)
    _hold(out, ref, la_atol=1e-4)
    if "prune" in case:
        assert (ref["prune0"] < ALIVE).any(), "pruning never fired"
    for i in "01":
        if f"keypoint_mask{i}" in data:
            assert (out[f"matches{i}"].numpy()[~data[f"keypoint_mask{i}"]] == -1).all()


def _first_c(out, model, m, n):
    """Per side, the active tokens at the exit (prune count stop + 2) and
    the first C of them, C the default capacity."""
    stop = int(out["stop_layer"])
    sides = []
    for key, k in (("prune0", m), ("prune1", n)):
        active = out[key] == stop + 2
        c = model._resolve_capacity(k)
        sides.append((active & (torch.cumsum(active, dim=1) <= c), active))
    return sides


@pytest.mark.parametrize("m,n,masked", SHAPES)
def test_exit_before_the_sets_fit_keeps_every_active_token(m, n, masked):
    """Exit at layer 0 with pruning on and `width_capacity: -1`: the active
    sets are over the default capacity, and the port and the JAX model both
    keep every active token for the exit assignment, so tokens past the first
    C are matched on both sides."""
    data = _data(5, 2, m, n, masked=masked)
    variables = _init(data, CONFIDENT)
    conf = {"depth_confidence": 0.95, "width_confidence": 0.8, "width_capacity": -1}
    out = _port(conf, variables)(_torch(data))
    ref = _jax(conf, variables, data)
    _hold(out, ref, la_atol=1e-4)
    assert int(out["stop_layer"]) == 0 and int(out["compact_layer"]) == -1
    (t0, a0), _ = _first_c(out, _port({**conf, "width_capacity": 0.5}, variables), m, n)
    assert int(t0.sum()) < int(a0.sum())
    assert bool((out["matches0"][a0 & ~t0] >= 0).any())
    assert (ref["matches0"][(a0 & ~t0).numpy()] >= 0).any()


@pytest.mark.parametrize("m,n,masked", SHAPES)
def test_default_capacity_truncates_as_jax_when_the_loop_ends_before_the_sets_fit(m, n, masked):
    """The same exit at the default `width_capacity` on both sides: the loop
    ends while the active sets are over C, and the port, like the JAX model
    (lightglue.py:735-762), keeps only the first C active tokens of each set
    for the exit assignment. Exit layer, prune counts, matches and the log
    assignment equal the JAX model's; no token past the first C is matched."""
    data = _data(5, 2, m, n, masked=masked)
    variables = _init(data, CONFIDENT)
    conf = {"depth_confidence": 0.95, "width_confidence": 0.8}
    model = _port(conf, variables)
    assert model.conf.width_capacity == 0.5
    out = model(_torch(data))
    ref = _jax(conf, variables, data)
    _hold(out, ref, la_atol=1e-4)
    assert int(out["stop_layer"]) == 0 and int(out["compact_layer"]) == -1
    for i, (kept, active) in enumerate(_first_c(out, model, m, n)):
        assert int(kept.sum()) < int(active.sum())
        assert bool((out[f"matches{i}"][active & ~kept] == -1).all())
        assert bool((out[f"matches{i}"][kept] >= 0).any())


def test_adaptive_through_the_block_ops_matches_jax():
    """256 keypoints a side: both phases (256 wide, then the compact 128) take
    the port's block ops, as on the card; the JAX model takes its unfused
    layer on the CPU. Pruning and compaction fire (width pruning alone: with
    untrained confidence heads every token counts as unsure and is kept)."""
    data = _data(6, 2, 256, 256, masked=True)
    variables = _init(data, ("assign_match_b", -1.0))
    conf = {"width_confidence": 0.8}
    model = _port(conf, variables)
    assert model._resolve_capacity(256) == 128
    out = model(_torch(data))
    ref = _jax(conf, variables, data)
    # after layer 1 every active set fits the capacity, so the last layer ran compact
    assert (ref["prune0"] >= 3).sum(1).max() <= 128 and (ref["prune1"] >= 3).sum(1).max() <= 128
    assert (ref["prune0"] >= ALIVE).sum() > 20 and (ref["prune0"] == 2).any()
    _hold(out, ref)
    both = (ref["prune0"] >= ALIVE)[:, :, None] & (ref["prune1"] >= ALIVE)[:, None, :]
    diff = np.abs(out["log_assignment"].numpy() - ref["log_assignment"])[:, :-1, :-1]
    assert diff[both].max() < 1e-4


def test_adaptive_mixed_precision_matches_jax():
    """mp: True runs the stack in bf16 on both sides, which round at other
    places (tests/test_torch_lightglue.py), and the exit and pruning
    decisions are hard thresholds on those values: the bars are `stop_layer`
    equal (the confidences sit far from the threshold here), prune counts
    equal on at least 95% of keypoints and `matches0` equal on at least 95%."""
    data = _data(7, 2, 64, 64, masked=True)
    variables = _init(data, UNMATCHABLE)
    conf = {"mp": True, "width_confidence": 0.8, "depth_confidence": 0.999999,
            "filter_threshold": 0.1}
    out = _port(conf, variables)(_torch(data))
    ref = _jax(conf, variables, data)
    assert int(out["stop_layer"]) == int(ref["stop_layer"]) == 2
    assert (out["prune0"].numpy() == ref["prune0"]).mean() >= 0.95
    assert (out["prune1"].numpy() == ref["prune1"]).mean() >= 0.95
    assert (out["matches0"].numpy() == ref["matches0"]).mean() >= 0.95
    assert (out["matches0"].numpy()[~data["keypoint_mask0"]] == -1).all()


# ------------------------------------------------------------- the whole slice
def _pair(seed, h=240, w=320, dy=5, dx=8):
    """A smooth random image and the same scene shifted by (dx, dy) pixels:
    an easy pair."""
    rng = np.random.RandomState(seed)
    big = gaussian_filter(rng.rand(h + dy, w + dx), 2.0)
    big = ((big - big.min()) / (big.max() - big.min())).astype(np.float32)
    return big[None, :h, :w, None], big[None, dy:, dx:, None]


def test_adaptive_pipeline_matches_jax_with_hermetic_weights():
    """SuperPoint-open -> adaptive LightGlue with the committed weights (their
    confidence heads are trained) in fp32 on an easy pair: the exit layer and
    the prune counts equal the JAX pipeline's, `matches0` on >= 99%."""
    conf = {
        "extractor": {"name": "superpoint_open", "max_num_keypoints": 256, "dtype": "float32"},
        "matcher": {"name": "lightglue", "filter_threshold": 0.1, "depth_confidence": 0.95,
                    "width_confidence": 0.99},
    }
    i0, i1 = _pair(0)
    size = np.asarray([[320.0, 240.0]], np.float32)
    jdata = {v: {"image": jnp.asarray(i), "image_size": jnp.asarray(size)}
             for v, i in (("view0", i0), ("view1", i1))}
    jp = jax_model("two_view_pipeline").from_conf(conf)
    variables = jax.tree.map(lambda a: a.astype(jnp.float32), load_npz_params(HERMETIC))
    ref = jax.tree.map(np.asarray, jax.jit(jp.apply)(variables, jdata))

    pipe = get_model("two_view_pipeline")(conf, device="cpu")
    pipe.load_state_dict(load_hermetic(device="cpu"))
    tdata = {v: {"image": torch.from_numpy(i), "image_size": torch.from_numpy(size)}
             for v, i in (("view0", i0), ("view1", i1))}
    out = pipe(tdata)
    assert int(out["stop_layer"]) == int(ref["stop_layer"])
    assert int(out["stop_layer"]) < 8, "the trained heads exit early on an easy pair"
    assert (out["prune0"].numpy() == ref["prune0"]).mean() >= 0.99
    assert (out["prune1"].numpy() == ref["prune1"]).mean() >= 0.99
    assert (out["matches0"].numpy() == ref["matches0"]).mean() >= 0.99
    assert (out["matches0"].numpy() >= 0).sum() > 20
    assert (out["matches0"].numpy()[~out["keypoint_mask0"].numpy()] == -1).all()
