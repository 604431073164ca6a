"""Training across processes (counterpart of
gluefactory_tpu/parallel/distributed.py and parallel/mesh.py).

The JAX package trains as one SPMD program over a 1-D data mesh: the global
batch is sharded over the devices, the parameters are replicated, and XLA
inserts the all-reduces inside the one jitted step (the gradients, the
non-finite veto and the batch-mode BatchNorm moments). The port runs one
process a GPU and keeps those semantics by hand:

  - every rank loads its slice `[r B/W, (r+1) B/W)` of each global batch of
    the one-process order (`BaseDataset.get_data_loader(shard=...)`);
  - the step all-reduces the flattened gradients, the loss and the logged
    losses in one call and divides by the world size: the global-batch
    means, and a veto that every rank takes together (`train/step.py`);
  - a batch-mode BatchNorm all-reduces its batch moments through an
    autograd-aware collective (`models/utils/layers.batch_norm`);
  - the parameters and buffers are broadcast from rank 0 after the model is
    built, seeded or restored; only rank 0 writes summaries, checkpoints
    and benchmarks (`train/trainer.py`).

`init_distributed` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and raises, naming what is missing,
when it is not there: a run asked to be distributed never carries on alone.
The backend is explicit, `nccl` by default, `gloo` on request (several
ranks on one GPU, or the CPU).
"""

from __future__ import annotations

import os
from typing import Any

import torch
import torch.distributed as dist

from ..models.base_model import resolve_device

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(backend: str = "nccl", device: Any = None) -> torch.device:
    """Join the process group described by torchrun's environment; returns
    this rank's device, `cuda:<LOCAL_RANK>` unless `device` names one."""
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"distributed training needs torchrun's environment; {', '.join(missing)} "
            f"not set (of {', '.join(ENV)}). Start it with `python -m torch.distributed.run "
            "--nproc_per_node N -m gluefactory_tpu_torch.train ... --distributed`")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = resolve_device(device if device is not None
                            else f"cuda:{int(os.environ['LOCAL_RANK'])}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@torch.no_grad()
def broadcast_state(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, in place."""
    for t in module.state_dict().values():
        dist.broadcast(t, 0)


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks, in place."""
    dist.all_reduce(t)
    return t.div_(dist.get_world_size())


def all_gather(obj) -> list:
    """Every rank's picklable `obj`, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


__all__ = ["ENV", "init_distributed", "world_size", "rank", "broadcast_state",
           "all_reduce_mean", "all_gather"]
