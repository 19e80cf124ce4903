"""Negative control for the costmodel checker: the radius-1 slab
exchange held to the radius-3 byte model."""

from stencil_tpu_torch.analysis.costmodel import CostModelTarget
from stencil_tpu_torch.analysis.entries import slab_exchange


def _wrong_model():
    spec = slab_exchange("r1")
    spec.expected_bytes_per_shard = slab_exchange("r3") \
        .expected_bytes_per_shard
    return spec


TARGETS = [CostModelTarget("fixture.costmodel.r1_priced_as_r3",
                           _wrong_model)]
