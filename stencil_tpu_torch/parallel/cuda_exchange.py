"""The remote-write halo exchange over a mesh of shards (``Method.PallasDMA``).

PyTorch-port counterpart of ``stencil_tpu/parallel/pallas_exchange.py``
``exchange_shard_pallas`` (:121-144): fill every halo of the padded
shards of a mesh by sequential axis sweeps in ``axis_order``, where each
sweep along an axis of more than one shard is one launch of B4 per shard
(``ops/cuda_exchange.py``: the shard stores its two boundary slabs
straight into its neighbours' halos), and a sweep along a one-shard axis
is the local periodic copy that ``exchange_shard`` already does, with
that axis's radius alone (JAX :133-139). Every slab spans the full
padded cross section, so edges and corners ride along from sweep to
sweep: every shard's sweep a lands before any shard's sweep a+1 starts
(an event join between the shards' streams). The halos equal those of
the slab method bit for bit.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List, Sequence, Tuple

import torch

from ..geometry import Dim3, Radius
from ..ops.cuda_exchange import ShardStreams, exchange_axis_cuda
from .exchange import ExchangeInFlight, _single_axis_radius, exchange_shard


def start_exchange_shard_cuda(fields: Sequence[Sequence[torch.Tensor]],
                              radius: Radius, mesh_counts: Dim3,
                              axis_order: Tuple[int, ...] = (0, 1, 2)
                              ) -> ExchangeInFlight:
    """Queue the sweeps of every quantity's shards (``fields[q][i]``:
    shard i of quantity q, x fastest) and return the handle whose
    ``wait()`` joins them back. On the card, shard i's sweeps of every
    quantity run on its own stream, after the work already queued on the
    current streams of the mesh's cards."""
    counts = Dim3.of(mesh_counts)
    shards0 = list(fields[0])
    if len(shards0) != counts.flatten():
        raise ValueError(f"{len(shards0)} shards for a {tuple(counts)} mesh")
    streams = (ShardStreams([t.device for t in shards0])
               if shards0[0].is_cuda else None)
    if streams is not None:
        streams.enter()
    first = True
    for a in axis_order:
        r_lo, r_hi = radius.face(a, -1), radius.face(a, 1)
        if r_lo == 0 and r_hi == 0:
            continue
        if streams is not None and not first:
            streams.join()
        first = False
        for shards in fields:
            arrs: List[torch.Tensor] = list(shards)
            if counts[a] > 1:
                exchange_axis_cuda(arrs, a, r_lo, r_hi, counts,
                                   streams=streams)
                continue
            # periodic self-neighbour: the local slab copy, on the
            # shard's own stream
            single = _single_axis_radius(radius, a)
            for i, p in enumerate(arrs):
                ctx = (torch.cuda.stream(streams[i]) if streams is not None
                       else nullcontext())
                with ctx:
                    exchange_shard([p], single, Dim3(1, 1, 1),
                                   axis_order=(a,))
    return ExchangeInFlight(streams)


def exchange_shard_cuda(shards: Sequence[torch.Tensor], radius: Radius,
                        mesh_counts: Dim3,
                        axis_order: Tuple[int, ...] = (0, 1, 2)
                        ) -> Sequence[torch.Tensor]:
    """Fill all halos of the padded (z,y,x) shards of a mesh (x fastest)
    in place with the remote-write sweeps; returns ``shards``. The same
    contract as ``exchange_shard`` for an evenly divided, periodic grid
    whose allocation is ``radius`` deep."""
    start_exchange_shard_cuda([shards], radius, mesh_counts,
                              axis_order).wait()
    return shards
