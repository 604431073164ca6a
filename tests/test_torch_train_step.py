"""The port's optimizer, training step and trainer against the JAX package
on the CPU.

  - identical numpy gradients through the optax chain of `make_optimizer`
    and through the port's optimizer: parameters to 1e-6, with one update
    over the clip norm and one beyond `lr_schedule.start`;
  - the non-finite veto leaves parameters, moments and count untouched;
  - two full steps (frozen SuperPoint-open, ground truth, 9-layer LightGlue,
    loss, update) on the committed weights at a tiny image size: losses to
    1e-4 relative against the JAX train step;
  - the trainer's checkpoint round trip resumes at the same step with the
    same next loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.models.matchers.lightglue_pretrained import load_npz_params
from gluefactory_tpu.train import step as jstep
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.train import step as tstep
from gluefactory_tpu_torch.train.trainer import Trainer
from gluefactory_tpu_torch.utils.config import load_conf
from gluefactory_tpu_torch.weights import HERMETIC, load_hermetic, params_to_jax

CONF = "superpoint-open+lightglue_homography"  # the training configuration
TRAIN = {"lr": 1e-3, "grad_clip": 1.0,
         "lr_schedule": {"type": "exp", "start": 1, "exp_div_10": 2}}


def test_optimizer_matches_optax():
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 4, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    # update 0 under the clip norm, update 1 far over it, update 2 beyond the schedule's start
    scales = (0.05, 30.0, 0.3)
    grads = [{k: (sc * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
             for sc in scales]
    norms = [np.sqrt(sum((g**2).sum() for g in gs.values())) for gs in grads]
    assert norms[0] < 1.0 < norms[1]

    tx = jstep.make_optimizer(TRAIN)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = tstep.make_optimizer(TRAIN, tparams)
    import optax

    for i, gs in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(g) for k, g in gs.items()}, opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update([torch.from_numpy(gs[k]) for k in opt.names])
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0, err_msg=f"update {i} {k}")
    assert opt.count == 3
    # the schedule reads the optimizer's count: lr, lr, lr * 10 ** (-1 / 2)
    sched = tstep.make_schedule(TRAIN)
    np.testing.assert_allclose([sched(0), sched(1), sched(2)], [1e-3, 1e-3, 1e-3 * 10**-0.5])


def _lightglue_batch(rng, nan=False):
    b, n, d = 2, 32, 64
    desc0 = rng.randn(b, n, d).astype(np.float32)
    if nan:
        desc0[0, 3, 5] = np.nan
    gt0 = np.full((b, n), -1, np.int32)
    gt0[:, :10] = np.arange(10)
    assignment = np.zeros((b, n, n), bool)
    assignment[:, np.arange(10), np.arange(10)] = True
    return {k: torch.from_numpy(v) for k, v in {
        "keypoints0": rng.rand(b, n, 2).astype(np.float32) * 100,
        "keypoints1": rng.rand(b, n, 2).astype(np.float32) * 100,
        "descriptors0": desc0, "descriptors1": rng.randn(b, n, d).astype(np.float32),
        "gt_matches0": gt0, "gt_matches1": gt0.copy(), "gt_assignment": assignment}.items()}


def test_nonfinite_veto_skips_the_whole_update():
    rng = np.random.RandomState(1)
    model = get_model("lightglue")({"n_layers": 2, "descriptor_dim": 64, "input_dim": 64,
                                    "num_heads": 2, "is_training": True}, device="cpu")
    params = dict(model.named_parameters())
    state = tstep.TrainState(0, params, tstep.make_optimizer(TRAIN, params))
    step = tstep.make_train_step(model)

    state, losses = step(state, _lightglue_batch(rng))
    assert float(losses["skipped_nonfinite"]) == 0.0 and state.optimizer.count == 1
    snap = {k: v.detach().clone() for k, v in params.items()}
    moments = [m.clone() for m in state.optimizer.mu + state.optimizer.nu]

    state, losses = step(state, _lightglue_batch(rng, nan=True))
    assert float(losses["skipped_nonfinite"]) == 1.0
    assert state.step == 2 and state.optimizer.count == 1  # the schedule did not advance
    for k, v in params.items():
        assert torch.equal(v, snap[k]), k
    for m, old in zip(state.optimizer.mu + state.optimizer.nu, moments):
        assert torch.equal(m, old)

    state, losses = step(state, _lightglue_batch(rng))
    assert float(losses["skipped_nonfinite"]) == 0.0 and state.optimizer.count == 2
    assert any(not torch.equal(v, snap[k]) for k, v in params.items())


def _pairs(seed, b, h=96, w=128, dx=7, dy=4):
    """Smooth random images and the same scenes shifted by (dx, dy) pixels,
    with the homography of the shift."""
    rng = np.random.RandomState(seed)
    big = np.stack([gaussian_filter(rng.rand(h + dy, w + dx), 1.5) for _ in range(b)])
    big = ((big - big.min()) / (big.max() - big.min())).astype(np.float32)
    H = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    H[:, 0, 2], H[:, 1, 2] = -dx, -dy
    return {"view0": {"image": big[:, :h, :w, None].copy()},
            "view1": {"image": big[:, dy:, dx:, None].copy()}, "H_0to1": H}


def _convert(data, fn):
    return {k: _convert(v, fn) if isinstance(v, dict) else fn(v) for k, v in data.items()}


def _tiny_conf():
    conf = load_conf(CONF)
    conf["model"]["extractor"].update(max_num_keypoints=48, dtype="float32")
    return conf


def test_two_full_steps_match_jax():
    conf = _tiny_conf()
    batches = [_pairs(s, 2) for s in (0, 1)]

    jm = jax_model("two_view_pipeline").from_conf(conf["model"])
    variables = jax.tree.map(lambda a: a.astype(jnp.float32), load_npz_params(HERMETIC))
    tx = jstep.make_optimizer(conf["train"])
    state = jstep.TrainState(jnp.zeros((), jnp.int32), variables["params"],
                             variables["batch_stats"], tx.init(variables["params"]))
    jtrain = jax.jit(jstep.make_train_step(jm, tx))

    trainer = Trainer(conf, device="cpu")
    trainer.load_weights(load_hermetic(device="cpu"))
    extractor_before = {k: v.clone() for k, v in trainer.model.extractor.state_dict().items()}
    out = trainer.train_steps([_convert(b, torch.from_numpy) for b in batches])

    for i, batch in enumerate(batches):
        state, ref = jtrain(state, _convert(batch, jnp.asarray))
        assert set(out[i]) == set(ref)
        assert float(ref["num_matchable"]) > 5
        for k in ref:
            np.testing.assert_allclose(out[i][k], float(ref[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    assert trainer.state.step == 2 == int(state.step)
    # the extractor is frozen; the trained matcher goes back to the JAX package as numpy
    for k, v in trainer.model.extractor.state_dict().items():
        assert torch.equal(v, extractor_before[k])
    tree = params_to_jax(trainer.model.state_dict())
    for k, v in state.params["matcher"].items():
        np.testing.assert_allclose(tree["params"]["matcher"][k], np.asarray(v), atol=5e-4)
        assert tree["params"]["matcher"][k].shape == v.shape


def test_checkpoint_round_trip(tmp_path):
    conf = _tiny_conf()
    conf["model"]["matcher"]["n_layers"] = 2
    batches = [_convert(_pairs(s, 2), torch.from_numpy) for s in (3, 4, 5)]
    a = Trainer(conf, device="cpu")
    a.train_steps(batches[:2])
    a.save(tmp_path / "ckpt.pt")
    expect = a.train_steps(batches[2:])[0]

    b = Trainer(conf, device="cpu")
    b.restore(tmp_path / "ckpt.pt")
    assert b.state.step == 2 and b.state.optimizer.count == 2
    got = b.train_steps(batches[2:])[0]
    assert b.state.step == 3
    for k in expect:
        np.testing.assert_allclose(got[k], expect[k], rtol=1e-6, err_msg=k)


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(load_conf(CONF))
