"""Negative control for the transfer checker: a step whose loop reads a
residual back to the host with ``.item()`` every iteration."""

import torch

from stencil_tpu_torch.analysis.entries import DispatchSpec
from stencil_tpu_torch.analysis.transfer import TransferTarget


def _item_in_loop():
    q = torch.rand(8, 8, 8)

    def step():
        for _ in range(3):
            q.mul_(0.5)
            if q.abs().max().item() < 1e-30:
                break

    return DispatchSpec(step, lambda: [q])


TARGETS = [TransferTarget("fixture.transfer.item_in_hot_loop",
                          _item_in_loop)]
