"""Negative control for the vmem checker: B8's plan asking for 240 KB of
dynamic shared memory a block (over Hopper's 227 KB)."""

import dataclasses

from stencil_tpu_torch.analysis.tiling import b8_plan
from stencil_tpu_torch.analysis.vmem import VmemTarget, small_plan

TARGETS = [VmemTarget("fixture.vmem.over_227kb", lambda: dataclasses.replace(
    small_plan(b8_plan), dynamic=240 * 1024))]
