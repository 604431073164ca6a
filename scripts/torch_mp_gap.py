"""The JAX package's own bf16-to-fp32 gap of a LightGlue training step at
the training configuration's width, on the CPU: the bar that chip_smoke.py
phase 13a holds the port's `mp: True` step to against its fp32 step.

    JAX_PLATFORMS=cpu python scripts/torch_mp_gap.py

LightGlue 9 x 256, 4 heads, checkpointed, with the committed weights
(weights/hermetic/sp_open_lg.npz), on two pairs of 512 keypoints (random
unit descriptors, the second set a noisy copy of the first, keypoints
related by a translation, their ground truth), for two seeds: the relative
gap of each pair's total loss and of the batch mean, and the gap of the
gradients of `self_Wqkv_w` and `assign_proj_w` as a share of their max|g|.
A CPU comparison, like the tests: it imports the JAX package as the
reference, and the port's test helpers for the batch.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
jax.config.update("jax_platforms", "cpu")

from gluefactory_tpu.models import get_model as jax_model  # noqa: E402
from gluefactory_tpu.models.matchers.lightglue_pretrained import load_npz_params  # noqa: E402
from gluefactory_tpu_torch.weights import HERMETIC  # noqa: E402
from test_torch_lightglue_train import _batch, _convert  # noqa: E402

CONF = {"n_layers": 9, "descriptor_dim": 256, "input_dim": 256, "num_heads": 4,
        "is_training": True, "checkpointed": True}


def main():
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                          load_npz_params(HERMETIC)["params"]["matcher"])
    for seed in (8, 9):
        rng = np.random.RandomState(seed)
        data = _batch(seed, 512, 512, False)
        d0 = rng.randn(2, 512, 256).astype(np.float32)
        d1 = d0 + 0.3 * rng.randn(2, 512, 256).astype(np.float32)
        data["descriptors0"] = d0 / np.linalg.norm(d0, axis=-1, keepdims=True)
        data["descriptors1"] = d1 / np.linalg.norm(d1, axis=-1, keepdims=True)
        jdata = _convert(data, jnp.asarray)

        def step(mp):
            model = jax_model("lightglue").from_conf({**CONF, "mp": mp})

            def loss(p):
                losses, _ = model.apply({"params": p}, model.apply({"params": p}, jdata), jdata,
                                        method="loss")
                return losses["total"].mean(), losses["total"]

            (total, per_pair), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
            return float(total), np.asarray(per_pair), jax.tree.map(np.asarray, grads)

        (t16, p16, g16), (t32, p32, g32) = step(True), step(False)
        print(f"seed {seed}: total {abs(t16 - t32) / abs(t32):.3g} relative, per pair "
              + " ".join(f"{x:.3g}" for x in np.abs(p16 - p32) / np.abs(p32)) + "; gradients "
              + ", ".join(f"{k} {np.abs(g16[k] - g32[k]).max() / np.abs(g32[k]).max():.3g}"
                          for k in ("self_Wqkv_w", "assign_proj_w")) + " of max|g|")


if __name__ == "__main__":
    main()
