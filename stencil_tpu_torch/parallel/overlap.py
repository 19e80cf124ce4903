"""Comm/compute overlap: the interior/exterior split of a step.

PyTorch-port counterpart of ``stencil_tpu/parallel/overlap.py`` (the
reference's interior-launch / exchange / exterior-launch choreography,
bin/jacobi3d.cu:296-377, src/stencil.cu:874-977
get_interior/get_exterior). The deep-interior block of every shard reads
only points the shard owns, so it is computed while the halo exchange is
in flight; the thin face slabs are computed from the exchanged shards
afterwards. Here "in flight" is literal for ``Method.PallasDMA``, whose
sweeps run on the shards' own CUDA streams while the inner blocks run on
the cards' current streams; the slab copy runs on the current streams
and so lands first.

Region decomposition (per shard, interior coordinates), as in JAX:

* inner block: points at least ``radius`` away from every face —
  ``[r_lo_a, n_a - r_hi_a)`` per axis;
* 6 face slabs of thickness ``r_lo``/``r_hi`` spanning the full cross
  section. Slabs overlap at edges and corners; those points are
  computed twice with identical values.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..geometry import Dim3, Radius
from .exchange import start_dispatch_exchange

# an update function: (padded blocks per field, interior dims of this
# region, region offset (x, y, z) in shard-interior coords, the shard's
# mesh position) -> dict of interior-shaped outputs for this region (the
# JAX version runs under shard_map, where the shard is implicit)
UpdateFn = Callable[[Dict[str, torch.Tensor], Dim3, Tuple[int, int, int],
                     int], Dict[str, torch.Tensor]]


def split_regions(radius: Radius, local: Dim3
                  ) -> Tuple[List[Tuple[Dim3, Dim3]], List[Tuple[Dim3, Dim3]]]:
    """(inner, exterior) region lists of (offset, dims) in interior
    coords (the get_interior/get_exterior analog, src/stencil.cu:874-977).
    Inner is empty when the shard is too thin to have one."""
    lo = radius.pad_lo()
    hi = radius.pad_hi()
    inner_dims = local - lo - hi
    if inner_dims.any_lt(1):
        return [], [(Dim3(0, 0, 0), local)]
    inner = [(Dim3(lo.x, lo.y, lo.z), inner_dims)]
    ext: List[Tuple[Dim3, Dim3]] = []
    for a in range(3):
        for side in (-1, 1):
            r = radius.face(a, side)
            if r == 0:
                continue
            off = [0, 0, 0]
            dims = [local.x, local.y, local.z]
            if side == 1:
                off[a] = local[a] - r
            dims[a] = r
            ext.append((Dim3(*off), Dim3(*dims)))
    return inner, ext


def _region_blocks(fields: Dict[str, torch.Tensor], radius: Radius,
                   off: Dim3, dims: Dim3) -> Dict[str, torch.Tensor]:
    """Padded block (a view) covering region [off, off+dims) plus its
    stencil reads: padded coords [off, lo + off + dims + hi)."""
    lo = radius.pad_lo()
    hi = radius.pad_hi()
    return {q: p[off.z:lo.z + off.z + dims.z + hi.z,
                 off.y:lo.y + off.y + dims.y + hi.y,
                 off.x:lo.x + off.x + dims.x + hi.x]
            for q, p in fields.items()}


def overlapped_update(fields: Dict[str, List[torch.Tensor]], radius: Radius,
                      mesh_counts: Dim3, method, update_fn: UpdateFn,
                      nonperiodic: bool = False,
                      ranks: Optional[Sequence[int]] = None
                      ) -> List[Optional[Dict[str, torch.Tensor]]]:
    """Run ``update_fn`` over the interior/exterior decomposition of
    every shard (``fields[q][i]``: padded shard i of quantity q, x
    fastest) with the halo exchange overlapping the inner blocks'
    compute. The exchange fills the halos IN PLACE (the JAX version
    returns the exchanged fields); returns, per shard, each key that
    ``update_fn`` produced assembled into a full interior-shaped
    tensor. The inner blocks are queued between the exchange's start
    and its ``wait``: they read the interiors, which the exchange never
    writes, so they see the pre-exchange values as JAX's do. ``ranks``:
    each position's owner on a mesh that spans processes (None in
    ``fields[q]``, and in the result, at the positions other ranks
    hold); the exchange's first direction of messages is then in flight
    while the inner blocks are queued."""
    lo = radius.pad_lo()
    hi = radius.pad_hi()
    names = list(fields)
    n = len(fields[names[0]])
    own = [i for i in range(n) if fields[names[0]][i] is not None]
    p0 = fields[names[0]][own[0]]
    local = Dim3(p0.shape[2] - lo.x - hi.x, p0.shape[1] - lo.y - hi.y,
                 p0.shape[0] - lo.z - hi.z)
    inner, ext = split_regions(radius, local)

    landed = start_dispatch_exchange(fields, radius, mesh_counts, method,
                                     nonperiodic=nonperiodic, ranks=ranks)
    pieces: List[List[Tuple[Dim3, Dict[str, torch.Tensor]]]] = [
        [] for _ in range(n)]
    for i in own:
        shard = {q: fields[q][i] for q in names}
        for off, dims in inner:
            pieces[i].append((off, update_fn(
                _region_blocks(shard, radius, off, dims), dims,
                (off.x, off.y, off.z), i)))
    landed.wait()
    for i in own:
        shard = {q: fields[q][i] for q in names}
        for off, dims in ext:
            pieces[i].append((off, update_fn(
                _region_blocks(shard, radius, off, dims), dims,
                (off.x, off.y, off.z), i)))

    out: List[Optional[Dict[str, torch.Tensor]]] = [None] * n
    for i in own:
        assembled: Dict[str, torch.Tensor] = {}
        for off, outs in pieces[i]:
            for key, val in outs.items():
                if key not in assembled:
                    assembled[key] = torch.zeros(
                        (local.z, local.y, local.x), dtype=val.dtype,
                        device=val.device)
                z, y, x = val.shape
                assembled[key][off.z:off.z + z, off.y:off.y + y,
                               off.x:off.x + x] = val
        out[i] = assembled
    return out
