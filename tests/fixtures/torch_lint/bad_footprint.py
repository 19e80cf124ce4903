"""Negative control for the footprint checker: a 7-point average that
declares radius 1 but reads two cells along +x (a radius-2 read)."""

from stencil_tpu_torch.analysis.footprint import StencilOpSpec, StencilOpTarget
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.ops.stencil_kernels import shifted

N = Dim3(8, 8, 8)
LO = Dim3(2, 2, 2)


def _reads_too_far(p):
    acc = shifted(p, (2, 0, 0), LO, N)
    for off in ((-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)):
        acc = acc + shifted(p, off, LO, N)
    return acc / 6.0


TARGETS = [StencilOpTarget("fixture.footprint.reads_radius_plus_one",
                           lambda: StencilOpSpec(_reads_too_far, (12, 12, 12),
                                                 Radius.constant(1), N,
                                                 pad_lo=LO))]
