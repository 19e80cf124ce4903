"""Negative controls for the recompile checker: a dispatch that builds a
kernel library every call (the build counter grows), and one whose
carry changes dtype between dispatches."""

import torch

from stencil_tpu_torch.analysis.entries import DispatchSpec
from stencil_tpu_torch.analysis.recompile import RecompileTarget
from stencil_tpu_torch.ops import _build


def _builds():
    q = torch.rand(8, 8, 8)

    def step():
        q.mul_(0.5)
        _build.BUILDS += 1   # what a build at first use would count

    return DispatchSpec(step, lambda: [q])


def _drifts():
    state = {"q": torch.rand(8, 8, 8)}

    def step():
        state["q"] = state["q"].to(torch.float64
                                   if state["q"].dtype == torch.float32
                                   else torch.float32)

    return DispatchSpec(step, lambda: [state["q"]])


TARGETS = [RecompileTarget("fixture.recompile.builds_every_dispatch",
                           _builds),
           RecompileTarget("fixture.recompile.carry_dtype_drifts",
                           _drifts)]
