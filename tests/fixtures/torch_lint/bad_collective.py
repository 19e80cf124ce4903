"""Negative controls for the collectives checker: an exchange whose
every rank sends its +z slab to the z neighbour that never posts the
receive, and a one-process exchange whose messages leave their mesh
line (each shard copies from a diagonal neighbour)."""

from stencil_tpu_torch.analysis.collectives import CollectiveTarget
from stencil_tpu_torch.analysis.entries import ExchangeSpec, shards_for
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.parallel.exchange import active_probe
from stencil_tpu_torch.parallel.mesh import mesh_neighbor
from stencil_tpu_torch.parallel.multihost import RankMessages

import torch

COUNTS = Dim3(2, 2, 2)


def _send_only():
    def run(view, ranks):
        sh = shards_for(COUNTS, (6, 6, 6), torch.float32, view, ranks)
        if view is None:
            probe = active_probe(None)
            for i in range(8):
                j = mesh_neighbor(i, COUNTS, 2, 1)
                sh[j][0].copy_(sh[i][-1])
                if probe is not None:
                    probe.moved("z", torch.float32, torch.float32,
                                torch.float32, 144, i, j)
            return
        msgs = RankMessages()
        for i in range(8):
            if ranks[i] == view:
                msgs.send(sh[i][-1].contiguous(),
                          ranks[mesh_neighbor(i, COUNTS, 2, 1)], i)
        msgs.run()
    return ExchangeSpec(COUNTS, run)


def _off_line():
    def run(view, ranks):
        if view is not None:
            return _send_only().run(view, ranks)
        sh = shards_for(COUNTS, (6, 6, 6), torch.float32, None, None)
        probe = active_probe(None)
        for i in range(8):
            j = mesh_neighbor(mesh_neighbor(i, COUNTS, 1, 1), COUNTS, 2, 1)
            sh[j][0].copy_(sh[i][-1])
            probe.moved("z", torch.float32, torch.float32, torch.float32,
                        144, i, j)
    return ExchangeSpec(COUNTS, run)


TARGETS = [CollectiveTarget("fixture.collectives.send_without_receive",
                            _send_only),
           CollectiveTarget("fixture.collectives.message_off_its_line",
                            _off_line)]
