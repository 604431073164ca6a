"""Pair-parallel matching (counterpart of
gluefactory_tpu/parallel/pair_matching.py).

The workload's scaling axis is image pairs: a batch of pairs is matched in
one call of the matcher on the device, with no traffic between the pairs.
Under `torch.distributed` with W > 1 ranks, each rank matches its slice
`[r B/W, (r+1) B/W)` of the pair axis (as `train/distributed.py` slices
batches) and the ranks all-gather `matches0` and `matching_scores0` in pair
order. This takes the place of the JAX package's mesh sharding.
"""

from __future__ import annotations

import torch

from ..train import distributed

GATHERED = ("matches0", "matching_scores0")


def make_pair_matcher(model):
    """Returns match_pairs(batch) -> pred for a model on its device. The
    batch's tensors have a leading pair axis (divisible by the world size);
    with one rank the whole prediction comes back, with several the pair
    axis of `matches0` and `matching_scores0`, gathered from every rank."""

    def match_pairs(batch):
        world, rank = distributed.world_size(), distributed.rank()
        if world == 1:
            return model(batch)
        lead = next(v for v in batch.values() if torch.is_tensor(v)).shape[0]
        assert lead % world == 0, f"pair count {lead} not divisible by {world} ranks"
        n = lead // world
        local = {k: v[rank * n:(rank + 1) * n] if torch.is_tensor(v) and v.dim() >= 1
                 and v.shape[0] == lead else v for k, v in batch.items()}
        pred = model(local)
        out = {}
        for k in GATHERED:
            parts = [torch.empty_like(pred[k]) for _ in range(world)]
            torch.distributed.all_gather(parts, pred[k].contiguous())
            out[k] = torch.cat(parts, 0)
        return out

    return match_pairs


__all__ = ["make_pair_matcher"]
