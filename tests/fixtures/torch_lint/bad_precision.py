"""Negative control for the precision checker: a step that sums its
float32 field in bfloat16 (an accumulation below the declared float32,
through a silent narrowing convert)."""

import torch

from stencil_tpu_torch.analysis.precision import PrecisionSpec, PrecisionTarget
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.parallel.mesh import Mesh


def _bf16_sum():
    q = torch.rand(8, 8, 8)

    def run():
        return q.to(torch.bfloat16).sum()

    return PrecisionSpec(run, Mesh(Dim3(1, 1, 1), ["cpu"]))


TARGETS = [PrecisionTarget("fixture.precision.bf16_accumulation",
                           _bf16_sum)]
