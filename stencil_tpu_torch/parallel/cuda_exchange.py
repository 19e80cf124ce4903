"""The remote-write halo exchange over a mesh of shards (``Method.PallasDMA``).

PyTorch-port counterpart of ``stencil_tpu/parallel/pallas_exchange.py``
``exchange_shard_pallas`` (:121-144): fill every halo of the padded
shards of a mesh by sequential axis sweeps in ``axis_order``. Each sweep
is one launch of B4 per card, covering every quantity and every shard
that card holds (``ops/cuda_exchange.py``: each shard stores its two
boundary slabs straight into its neighbours' halos). Along a one-shard
axis the neighbour is the shard itself, so the same kernel does the
local periodic copy that JAX does there with that axis's radius alone
(:133-139). Every slab spans the full padded cross section, so edges and
corners ride along from sweep to sweep: every card's sweep a lands
before any card's sweep a+1 starts. The halos equal those of the slab
method bit for bit. On a mesh that spans processes each rank launches
on its own cards and stores into the other ranks' shards through CUDA
IPC, every sweep ordered by device-side flags (``ops/cuda_exchange.py``,
``parallel/ipc.py``); on CPU shards the twin sends those slabs as
messages.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..geometry import Dim3, Radius
from ..ops.cuda_exchange import start_sweeps
from .exchange import ExchangeInFlight


def start_exchange_shard_cuda(fields: Sequence[Sequence[torch.Tensor]],
                              radius: Radius, mesh_counts: Dim3,
                              axis_order: Tuple[int, ...] = (0, 1, 2),
                              ranks: Optional[Sequence[int]] = None
                              ) -> ExchangeInFlight:
    """Queue the sweeps of every quantity's shards (``fields[q][i]``:
    shard i of quantity q, x fastest) and return the handle whose
    ``wait()`` joins them back. On the card the sweeps run on one side
    stream per card, after the work already queued on the current
    streams of the mesh's cards; on the CPU they run at once.
    ``ranks``: each position's owner on a mesh that spans processes
    (None in ``fields[q]`` at the positions other ranks own); still one
    launch per card and sweep, each rank counting its own."""
    sweeps = [(a, radius.face(a, -1), radius.face(a, 1)) for a in axis_order
              if radius.face(a, -1) or radius.face(a, 1)]
    return ExchangeInFlight(start_sweeps(fields, sweeps,
                                         Dim3.of(mesh_counts), ranks))


def exchange_shard_cuda(shards: Sequence[torch.Tensor], radius: Radius,
                        mesh_counts: Dim3,
                        axis_order: Tuple[int, ...] = (0, 1, 2),
                        ranks: Optional[Sequence[int]] = None
                        ) -> Sequence[torch.Tensor]:
    """Fill all halos of the padded (z,y,x) shards of a mesh (x fastest)
    in place with the remote-write sweeps; returns ``shards``. The same
    contract as ``exchange_shard`` for an evenly divided, periodic grid
    whose allocation is ``radius`` deep."""
    start_exchange_shard_cuda([shards], radius, mesh_counts,
                              axis_order, ranks).wait()
    return shards
