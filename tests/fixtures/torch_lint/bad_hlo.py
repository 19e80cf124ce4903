"""Negative control for the hlo checker: an exchange that, besides its
point-to-point messages, reduces every shard with ``all_reduce`` (a
collective the exchange does not declare)."""

import torch

from stencil_tpu_torch.analysis.entries import slab_exchange
from stencil_tpu_torch.analysis.hlo import HloTarget


def _with_all_reduce():
    spec = slab_exchange("r1")
    run = spec.run

    def run_and_reduce(view, ranks):
        run(view, ranks)
        if view is not None:
            import torch.distributed as dist

            dist.all_reduce(torch.zeros(4))
    spec.run = run_and_reduce
    return spec


TARGETS = [HloTarget("fixture.hlo.exchange_with_all_reduce",
                     _with_all_reduce)]
