"""The training step (counterpart of gluefactory_tpu/train/step.py):
forward, loss, backward, the non-finite veto, gradient clipping and the
Adam update, for one device.

The optimizer repeats the JAX package's optax chain exactly:
`clip_by_global_norm(grad_clip)` scales the gradients by max_norm / norm
only when norm >= max_norm (no epsilon), then `adam` (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, no weight decay) with the learning rate
read from the schedule at the optimizer's own count before it is
incremented. Parameters and moments are updated in place. The schedules:
none (constant), `exp` (decay by 10 every `exp_div_10` steps after
`start`) and `cosine` (optax's `cosine_decay_schedule(lr, steps)`: half a
cosine from lr down to 0 at `steps`, 0 after).

The veto: when the loss or any gradient is not finite, the whole update is
skipped. Parameters, both moments and the optimizer's count (so the
schedule) keep their values, `step` still advances and the losses report
`skipped_nonfinite = 1`. Reading that flag costs one host synchronisation
a step.

With `grad_stats`, the losses also hold `grad/norm`, the global norm of the
gradients before the clip (0 on a vetoed step, whose gradients the JAX step
zeroes), and `grad/norm/<module>` for each top-level module with
parameters (0 for a frozen one).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


def make_schedule(conf) -> Callable[[int], float]:
    """Learning rate as a function of the optimizer's count."""
    lr = conf.get("lr", 1e-4)
    sched = conf.get("lr_schedule") or {"type": None}
    stype = sched.get("type")
    if stype == "exp":
        start, div = sched.get("start", 0), sched.get("exp_div_10", 1e5)
        return lambda i: lr * 10.0 ** (-max(i - start, 0) / div)
    if stype == "cosine":
        steps = sched.get("steps", 100_000)
        return lambda i: lr * 0.5 * (1.0 + math.cos(math.pi * min(i, steps) / steps))
    if stype is None:
        return lambda i: lr
    raise NotImplementedError(f"lr_schedule type {stype!r} is not ported yet")


class Optimizer:
    """Global-norm clip + Adam over a dict of named parameters."""

    def __init__(self, params: dict, conf):
        if conf.get("optimizer", "adam") != "adam":
            raise NotImplementedError("only the adam optimizer is ported")
        self.names = list(params)
        self.params = [params[k] for k in self.names]
        self.schedule = make_schedule(conf)
        self.max_norm = float(conf.get("grad_clip", 10.0))
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads: list) -> None:
        """One clipped Adam update of the parameters, in place. The caller
        has checked that the gradients are finite."""
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        factor = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        grads = torch._foreach_mul(grads, factor)
        torch._foreach_lerp_(self.mu, grads, 1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        lr = self.schedule(self.count)
        self.count += 1
        c1, c2 = 1 - self.b1**self.count, 1 - self.b2**self.count
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, self.mu, denom, value=-lr / c1)

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for name, mu, nu in zip(self.names, self.mu, self.nu):
            mu.copy_(state["mu"][name])
            nu.copy_(state["nu"][name])


def make_optimizer(conf, params: dict) -> Optimizer:
    """The optimizer of a train conf (lr, lr_schedule, grad_clip) over the
    named trainable parameters."""
    return Optimizer(params, conf)


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the step counter, the trainable parameters
    (shared with the model, updated in place) and the optimizer."""

    step: int
    params: dict
    optimizer: Optimizer


def module_of(name: str) -> str:
    """The top-level module of a parameter name (`matcher.x_w` -> `matcher`)."""
    return name.split(".", 1)[0]


def make_train_step(model, mark: Optional[Callable[[str], None]] = None,
                    grad_stats: bool = False):
    """Build `train_step(state, batch) -> (state, losses)` for a two-view
    pipeline style model (`model(batch)`, `model.loss(pred, batch)`).

    `losses` holds the batch mean of every entry of the model's losses, as
    0-d tensors on the model's device, `skipped_nonfinite` and, with
    `grad_stats`, the gradient norms. `mark(name)` is called after the
    "forward" (model and loss), the "backward" and the "optimizer" phase,
    for timing."""
    mark = mark or (lambda name: None)
    modules = sorted({module_of(k) for k, _ in model.named_parameters()})

    def train_step(state: TrainState, batch: dict):
        params = list(state.params.values())
        pred = model(batch)
        losses, _ = model.loss(pred, batch)
        loss = losses["total"].mean()
        mark("forward")
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        mark("backward")
        finite = torch.stack([torch.isfinite(g).all() for g in grads]
                             + [torch.isfinite(loss)]).all()
        skipped = not bool(finite)  # the step's one host synchronisation
        out = {k: v.detach().float().mean() for k, v in losses.items()}
        if grad_stats:
            out.update(_grad_norms(state.params, grads, modules, skipped, loss.device))
        if not skipped:
            state.optimizer.update(grads)
        state.step += 1
        out["skipped_nonfinite"] = torch.tensor(float(skipped), device=loss.device)
        mark("optimizer")
        return state, out

    return train_step


@torch.no_grad()
def _grad_norms(params: dict, grads: list, modules: list, skipped: bool, device) -> dict:
    sq = {m: torch.zeros((), device=device) for m in modules}
    if not skipped:
        for name, g in zip(params, grads):
            sq[module_of(name)] = sq[module_of(name)] + g.float().square().sum()
    out = {"grad/norm": torch.sqrt(sum(sq.values()))}
    out.update({f"grad/norm/{m}": torch.sqrt(v) for m, v in sq.items()})
    return out


__all__ = ["TrainState", "Optimizer", "make_optimizer", "make_schedule", "make_train_step"]
