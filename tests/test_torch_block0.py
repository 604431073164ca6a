"""SuperPoint's fused block 0 of the port against the JAX package on the CPU.

`block0_plain` (the port's plain version, which the wrapper runs for CPU
tensors) against the Pallas kernel `block0_fused` in interpret mode, on the
same image and weights. Bars: the JAX package's own for this kernel
(tests/test_pallas_kernels.py: atol 5e-2 + rtol 5e-2, bf16 outputs of
magnitude ~1) and, tighter, a mean absolute error under 5e-3: both sides
round to bf16 at the same points, so they differ by an ulp on few entries.
Then the whole extractor with `fused_block0: True` on both sides and the
committed weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.models.matchers.lightglue_pretrained import load_npz_params
from gluefactory_tpu.ops.pallas_conv import block0_fused as jax_block0
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.ops.block0_conv import block0_fused, block0_plain
from gluefactory_tpu_torch.weights import HERMETIC, params_from_jax


def _weights(rng):
    """Random weights as in tests/test_pallas_kernels.py: (w1, b1, mul1, add1,
    w2, b2, mul2, add2)."""
    w1 = rng.randn(3, 3, 1, 64) * 0.3
    w2 = rng.randn(3, 3, 64, 64) * 0.05
    b1, b2 = rng.randn(64) * 0.1, rng.randn(64) * 0.1
    mul1, add1 = rng.rand(64) + 0.5, rng.randn(64) * 0.1
    mul2, add2 = rng.rand(64) + 0.5, rng.randn(64) * 0.1
    return [a.astype(np.float32) for a in (w1, b1, mul1, add1, w2, b2, mul2, add2)]


@pytest.mark.parametrize("shape,bright_border", [
    ((2, 64, 96), False),
    ((2, 64, 96), True),   # a wrong halo (conv1a of a padded image) shows at the border
    ((1, 40, 56), True),   # pooled 20 x 28: no multiple of the CUDA kernel's 8 x 8 tile
])
def test_block0_plain_matches_pallas_kernel(shape, bright_border):
    rng = np.random.RandomState(sum(shape) + bright_border)
    b, h, w = shape
    img = rng.rand(b, h, w, 1).astype(np.float32)
    if bright_border:
        img *= 0.3
        img[:, :2], img[:, -2:], img[:, :, :2], img[:, :, -2:] = 1.0, 1.0, 1.0, 1.0
    weights = _weights(rng)
    ref = np.asarray(jax_block0(jnp.asarray(img), *map(jnp.asarray, weights), interpret=True),
                     np.float32)
    args = [torch.from_numpy(a) for a in weights]
    out = block0_plain(torch.from_numpy(img), *args)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, h // 2, w // 2, 64)
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, atol=5e-2, rtol=5e-2)
    assert np.abs(out - ref).mean() < 5e-3
    # at the border the two must agree as well as inside
    edge = np.ones(out.shape[1:3], bool)
    edge[1:-1, 1:-1] = False
    assert np.abs(out - ref)[:, edge].mean() < 5e-3
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(block0_fused(torch.from_numpy(img), *args).float(),
                       torch.from_numpy(out))


def test_block0_zero_pads_the_first_conv_output():
    """With a bias that survives the ReLU, conv1a of a zero-padded image is
    not zero outside the image; conv1b must still see zeros there."""
    rng = np.random.RandomState(7)
    weights = [torch.from_numpy(a) for a in _weights(rng)]
    weights[1] = torch.full((64,), 0.5)  # b1
    img = torch.zeros(1, 8, 8, 1)
    out = block0_plain(img, *weights).float()
    # an all-zero image: every conv1a output inside is relu(b1) * mul1 + add1, so the
    # interior of conv1b sees a constant field and the border rows see the zero padding
    assert not torch.allclose(out[0, 0, 0], out[0, 1, 1], atol=1e-3)
    assert torch.allclose(out[0, 1, 1], out[0, 2, 2], atol=1e-6)


def test_block0_rejects_odd_sides_and_wrong_shapes():
    weights = [torch.from_numpy(a) for a in _weights(np.random.RandomState(0))]
    with pytest.raises(ValueError, match="even"):
        block0_fused(torch.zeros(1, 7, 8, 1), *weights)
    with pytest.raises(ValueError, match="B, H, W, 1"):
        block0_fused(torch.zeros(1, 8, 8, 3), *weights)
    # the extractor does not route an odd side around the kernel: it raises too
    ext = get_model("superpoint_open")({"fused_block0": True}, device="cpu")
    with pytest.raises(ValueError, match="even"):
        ext({"image": torch.zeros(1, 63, 64, 1)})


def _image(seed, b, h, w):
    rng = np.random.RandomState(seed)
    img = np.stack([gaussian_filter(rng.rand(h, w), 1.0) for _ in range(b)])
    img = (img - img.min()) / (img.max() - img.min())
    return img[..., None].astype(np.float32)


@pytest.mark.parametrize("fused", [True, "auto"])
def test_extractor_with_fused_block0_matches_jax(fused):
    """The extractor with the committed weights, block 0 fused on both sides
    (the JAX model runs its Pallas kernel in interpret mode off a TPU), the
    rest of the trunk in float32. Block 0's bf16 output differs by an ulp on
    few entries, which moves a few scores across the NMS and the threshold:
    at least 90% of each side's keypoints are also the other's, and on those
    descriptors agree within 2e-2 and scores within 2e-2. "auto" is off on the
    CPU, so there the port's plain trunk (float32 block 0) is held to the
    same bars against the JAX model's bf16 block 0."""
    conf = {"max_num_keypoints": 100, "dtype": "float32", "fused_block0": fused}
    img = _image(3, 2, 64, 96)
    tree = load_npz_params(HERMETIC)
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), {
        "params": tree["params"]["extractor"], "batch_stats": tree["batch_stats"]["extractor"]})
    jm = jax_model("superpoint_open").from_conf({**conf, "fused_block0": True})
    ref = jax.tree.map(np.asarray, jax.jit(jm.apply)(variables, {"image": jnp.asarray(img)}))

    tm = get_model("superpoint_open")(conf, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    out = {k: v.numpy() for k, v in tm({"image": torch.from_numpy(img)}).items()}

    common = 0
    for b in range(img.shape[0]):
        mine = {tuple(p): i for i, p in enumerate(out["keypoints"][b]) if out["keypoint_mask"][b, i]}
        theirs = {tuple(p): i for i, p in enumerate(ref["keypoints"][b])
                  if ref["keypoint_mask"][b, i]}
        both = sorted(set(mine) & set(theirs))
        assert len(both) >= 0.9 * max(len(mine), len(theirs)) and len(both) > 20
        common += len(both)
        i, j = [mine[p] for p in both], [theirs[p] for p in both]
        np.testing.assert_allclose(out["descriptors"][b, i], ref["descriptors"][b, j], atol=2e-2)
        np.testing.assert_allclose(out["keypoint_scores"][b, i], ref["keypoint_scores"][b, j],
                                   atol=2e-2)
    assert common > 60
