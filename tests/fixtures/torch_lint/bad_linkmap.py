"""Negative control for the linkmap checker: the radius-1 slab exchange
held to a matrix off by one message (one more 0 -> 1 edge)."""

from stencil_tpu_torch.analysis.entries import slab_exchange
from stencil_tpu_torch.observatory.linkmap import LinkmapTarget, TrafficEdge


def _one_more():
    spec = slab_exchange("r1")
    model = spec.traffic

    def traffic():
        tm = model()
        tm.add(TrafficEdge(0, 1, "x", 1, 784, {"face": 784}))
        return tm
    spec.traffic = traffic
    return spec


TARGETS = [LinkmapTarget("fixture.linkmap.off_by_one_message", _one_more)]
