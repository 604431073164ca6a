"""The training step (counterpart of gluefactory_tpu/train/step.py):
forward, loss, backward, the non-finite veto, gradient clipping and the
Adam update, on one device, or on one device a process across processes.

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
skipped. Parameters, both moments, the optimizer's count (so the schedule)
and the model's buffers (the running statistics that a batch-mode
BatchNorm moved in the forward, as the JAX step keeps the old
`batch_stats`) keep their values, `step` still advances and the losses
report `skipped_nonfinite = 1`. Reading that flag costs one host
synchronisation a step; the buffers are copied before the forward (a few
KiB) and put back only on a vetoed step, which adds no host read.

With `grad_stats`, the losses also hold `grad/norm`, the global norm of the
gradients before the clip (0 on a vetoed step, whose gradients the JAX step
zeroes), and `grad/norm/<module>` for each top-level module with
parameters (0 for a frozen one).

Across processes (a default process group of more than one rank when the
step is built, `train/distributed.py`) each rank runs its slice of the
global batch. The gradients are taken by
`torch.autograd.grad`, under which DDP's reducer hooks do not fire, so the
step makes the counterpart of the JAX program's psum itself: one
all-reduce a step of the flattened gradients, the loss and the logged
losses, divided by the world size. That gives the gradient of the
global-batch mean loss, the global means in the losses, and a veto that
reads the reduced values, so that every rank skips together.
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
    """Build `train_step(state, batch) -> (state, losses)` for any model with
    `model(batch)` and `model.loss(pred, batch)`: a two-view pipeline, or a
    bare extractor such as SuperPoint-open in its pretraining.

    `losses` holds the batch mean of every entry of the model's losses, as
    0-d tensors on the model's device, `skipped_nonfinite` and, with
    `grad_stats`, the gradient norms. `mark(name)` is called after the
    "forward" (model and loss), the "backward" and the "optimizer" phase,
    for timing. Across processes the step all-reduces over the default
    process group (the module docstring)."""
    from .distributed import world_size

    mark = mark or (lambda name: None)
    distributed = world_size() > 1
    modules = sorted({module_of(k) for k, _ in model.named_parameters()})
    buffers = list(model.buffers())

    def train_step(state: TrainState, batch: dict):
        params = list(state.params.values())
        saved = [b.clone() for b in buffers]
        pred = model(batch)
        losses, _ = model.loss(pred, batch)
        loss = losses["total"].mean()
        mark("forward")
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        out = {k: v.detach().float().mean() for k, v in losses.items()}
        if distributed:
            grads, loss, out = _all_reduce(grads, loss, out)
        mark("backward")
        finite = torch.stack([torch.isfinite(g).all() for g in grads]
                             + [torch.isfinite(loss)]).all()
        skipped = not bool(finite)  # the step's one host synchronisation
        if grad_stats:
            out.update(_grad_norms(state.params, grads, modules, skipped, loss.device))
        if skipped:
            restore_buffers(buffers, saved)
        else:
            state.optimizer.update(grads)
        state.step += 1
        out["skipped_nonfinite"] = torch.tensor(float(skipped), device=loss.device)
        mark("optimizer")
        return state, out

    return train_step


@torch.no_grad()
def _all_reduce(grads: list, loss: torch.Tensor, out: dict):
    """The means over the ranks of the gradients, the loss and the logged
    losses, by one all-reduce of their concatenation."""
    from .distributed import all_reduce_mean

    parts = [g.reshape(-1) for g in grads] + [loss.detach().float().reshape(1)] + [
        v.reshape(1) for v in out.values()]
    flat = all_reduce_mean(torch.cat(parts))
    pieces = flat.split([p.numel() for p in parts])
    grads = [p.view_as(g) for p, g in zip(pieces, grads)]
    values = pieces[len(grads) + 1:]
    return grads, pieces[len(grads)][0], {k: v[0] for k, v in zip(out, values)}


@torch.no_grad()
def restore_buffers(buffers: list, saved: list) -> None:
    """Put copies taken by `[b.clone() for b in buffers]` back, in place."""
    for b, s in zip(buffers, saved):
        b.copy_(s)


@torch.no_grad()
def _grad_norms(params: dict, grads: list, modules: list, skipped: bool, device) -> dict:
    sq = {m: torch.zeros((), device=device) for m in modules}
    if not skipped:
        for name, g in zip(params, grads):
            sq[module_of(name)] = sq[module_of(name)] + g.float().square().sum()
    out = {"grad/norm": torch.sqrt(sum(sq.values()))}
    out.update({f"grad/norm/{m}": torch.sqrt(v) for m, v in sq.items()})
    return out


__all__ = ["TrainState", "Optimizer", "make_optimizer", "make_schedule", "make_train_step",
           "restore_buffers"]
