#!/usr/bin/env python3
"""How far the port's bf16 path sits from the JAX package's, on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/torch_bf16_parity.py

Prints the statistics behind three CPU tests' bars, on their own inputs:
- the plain bf16 attention against the XLA path
  (`tests/test_torch_attention_train.py::test_plain_bf16_attention_rounds_where_the_xla_path_does`):
  the share of outputs that differ and the largest difference, also of
  the self form's gradients and of the whole cross form, op by op and
  jitted;
- full-depth LightGlue with `mp: True` against the JAX model
  (`tests/test_torch_lightglue.py::test_matcher_mixed_precision_matches_jax`):
  the share of equal `matches0` on the valid keypoints (bar 0.95);
- one `mp: True` training step against JAX's
  (`tests/test_torch_lightglue_train.py::test_mp_training_step_within_the_jax_bf16_gap`):
  each loss entry's largest difference from JAX's bf16 step, relative
  (bar 2**-8), and each gradient's largest difference as a share of JAX's
  own bf16-to-fp32 gap (bar 2), the largest four and the mean.
`--rounding` swaps the plain attention's rounding for an alternative
(`round_as` in scripts/torch_mp_step.py: the probabilities kept in fp32,
or the cross form's scale of qk as the XLA cross form takes it, jitted or
op by op) to see which moves the port towards JAX; `--seeds N`
repeats the LightGlue and training comparisons on N input seeds. Run it on
two trees (a parent unpacked with `git archive`) to see what a change of
the bf16 path moved. About two minutes a seed.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_attention_train as tat  # noqa: E402
import test_torch_lightglue as tl  # noqa: E402
import test_torch_lightglue_train as tlt  # noqa: E402
from gluefactory_tpu.models import get_model as jax_model  # noqa: E402
from gluefactory_tpu.ops import attention as jattn  # noqa: E402
from gluefactory_tpu_torch.ops import attention as plain  # noqa: E402
from torch_mp_step import ROUNDINGS, round_as  # noqa: E402  (this directory)


def plain_attention():
    """The rounding test's inputs: the share of outputs that differ from
    the XLA path's, and the largest difference. The self form forward and
    gradients (a bf16 cotangent) against the jitted `jax.vjp` of
    `self_attention_packed`; the cross form each direction against
    `masked_attention` (the test's comparison) and whole against
    `cross_attention_bidirectional_packed`, op by op and jitted."""
    H, D = tat.H, tat.D
    b, m, n = 2, 70, 150

    def draw():
        rng = np.random.RandomState(11)
        return rng, tat._masks(rng, b, m, "masked"), tat._masks(rng, b, n, "empty_set")

    rng, mask0, mask1 = draw()
    heads = lambda a: a.reshape(b, -1, H, D).transpose(0, 2, 1, 3)
    packed = lambda a: a.transpose(0, 2, 1, 3).reshape(b, -1, H * D)
    jm0, jm1 = jnp.asarray(mask0), jnp.asarray(mask1)
    tb = lambda a: torch.from_numpy(a).bfloat16()

    def show(what, names, outs, refs):
        for name, o, r in zip(names, outs, refs):
            diff = np.abs(o.detach().float().numpy() - np.asarray(r.astype(jnp.float32)))
            print(f"plain bf16 {what} {name}: {float((diff != 0).mean()):.4%} of outputs differ "
                  f"from the XLA path's, max {float(diff.max()):.4g}")

    x = [rng.randn(b, n, H * D).astype(np.float32) for _ in range(4)]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in x]
    jself = lambda q, k, v: jattn.self_attention_packed(q, k, v, jm1, H, impl="xla")
    ref, vjp = jax.jit(lambda q, k, v: jax.vjp(jself, q, k, v))(*jx[:3])
    refs = (ref, *jax.jit(vjp)(jx[3]))
    t = [tb(a).requires_grad_() for a in x[:3]]
    out = plain.self_attention_packed(*t, torch.from_numpy(mask1), H)
    out.backward(tb(x[3]))
    show("self attention (jitted vjp)", ("out", "dq", "dk", "dv"), (out, *(a.grad for a in t)),
         refs)

    rng = draw()[0]
    x = [rng.randn(b, r, H * D).astype(np.float32) for r in (m, n, m, n)]
    out = plain.cross_attention_bidirectional_packed(
        *(tb(a) for a in x), torch.from_numpy(mask0), torch.from_numpy(mask1), H)
    qk0, qk1, v0, v1 = (heads(jnp.asarray(a, jnp.bfloat16)) for a in x)
    show("cross attention, each direction against masked_attention", ("m0", "m1"), out,
         [packed(jattn.masked_attention(qk0, qk1, v1, jm0, jm1, impl="xla")),
          packed(jattn.masked_attention(qk1, qk0, v0, jm1, jm0, impl="xla"))])
    cross = lambda *a: jattn.cross_attention_bidirectional_packed(*a, jm0, jm1, H, impl="xla")
    jx = [jnp.asarray(a, jnp.bfloat16) for a in x]
    show("cross attention, op by op", ("m0", "m1"), out, cross(*jx))
    show("cross attention, jitted", ("m0", "m1"), out, jax.jit(cross)(*jx))


def lightglue_matches(seed):
    data = tl._data(seed, 2, 128, 128, True)
    ref, out = tl._run_both(data, {"mp": True, "fused_layer": False, "filter_threshold": 0.1}, 9)
    valid = data["keypoint_mask0"]
    same = out["matches0"].numpy()[valid] == np.asarray(ref["matches0"])[valid]
    print(f"seed {seed}: LightGlue mp: True, matches0 equal to JAX's on {same.mean():.4f} of "
          "valid keypoints (bar 0.95)")
    return same.mean()


def training_step(seed):
    data = tlt._batch(seed, 48, 48, True)
    conf = {**tlt.BASE, "is_training": True, "checkpointed": True, "mp": True}
    _, variables, jdata, tm, tdata = tlt._both(conf, data)

    def jax_step(mp):
        model = jax_model("lightglue").from_conf({**conf, "mp": mp})

        def jloss(params):
            losses, _ = model.apply({"params": params}, model.apply({"params": params}, jdata),
                                    jdata, method="loss")
            return losses["total"].mean(), losses

        (_, losses), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            variables["params"])
        return jax.tree.map(np.asarray, losses), jax.tree.map(np.asarray, grads)

    (l16, g16), (_, g32) = jax_step(True), jax_step(False)
    losses, _ = tm.loss(tm(tdata), tdata)
    for key, v in losses.items():
        a, r = v.detach().float().numpy(), l16[key]
        rel = float(np.max(np.abs(a - r) / np.maximum(np.abs(r), 1e-6)))
        print(f"seed {seed}: mp training step, loss {key}: max relative difference from "
              f"JAX's bf16 {rel:.3g} (bar 2**-8 = 0.0039 + 1e-6 abs)")
    losses["total"].mean().backward()
    ratios = {name: float(np.abs(p.grad.numpy() - g16[name]).max()
                          / np.abs(g16[name] - g32[name]).max())
              for name, p in tm.named_parameters()}
    top = sorted(ratios.items(), key=lambda kv: kv[1])[-4:]
    print(f"seed {seed}: mp training step, gradient difference from JAX's bf16 as a share of "
          f"JAX's own bf16-to-fp32 gap (bar 2): mean {np.mean(list(ratios.values())):.4f}, "
          "largest " + ", ".join(f"{k} {v:.4f}" for k, v in top))
    return np.mean(list(ratios.values())), top[-1][1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounding", choices=ROUNDINGS, default="port")
    parser.add_argument("--seeds", type=int, default=1)
    args = parser.parse_args()
    round_as(args.rounding)
    print(f"rounding: {args.rounding}")
    plain_attention()
    same = [lightglue_matches(5 + i) for i in range(args.seeds)]
    steps = [training_step(8 + i) for i in range(args.seeds)]
    print(f"over {args.seeds} seeds: matches0 equal {np.mean(same):.4f} (least "
          f"{np.min(same):.4f}); gradient ratio mean {np.mean([m for m, _ in steps]):.4f}, "
          f"largest {np.max([t for _, t in steps]):.4f} (mean of the seeds' largest "
          f"{np.mean([t for _, t in steps]):.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
