"""Negative control for the donation checker: a step that computes the
new field out of place and rebinds the carry to it on every dispatch."""

import torch

from stencil_tpu_torch.analysis.donation import DonationTarget
from stencil_tpu_torch.analysis.entries import DispatchSpec


def _rebinds():
    state = {"q": torch.rand(16, 16, 16)}

    def step():
        state["q"] = state["q"] * 0.5 + 1.0

    return DispatchSpec(step, lambda: [state["q"]])


TARGETS = [DonationTarget("fixture.donation.carry_reallocated", _rebinds)]
