"""Stencil compute on padded (z,y,x) shards, in plain PyTorch.

PyTorch-port counterpart of ``stencil_tpu/ops/stencil_kernels.py``:
the ``xla`` path's math (reference: bin/jacobi3d.cu:40-85
stencil_kernel). Each function takes a halo-padded shard and produces
interior values through slicing. It runs on any device and accepts
float32 and float64; it is the port's plain reference path, not a
kernel. The hand-written CUDA kernels live in ``cuda_stencil.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..geometry import Dim3, Radius


def shifted(padded: torch.Tensor, off: Tuple[int, int, int],
            pad_lo: Dim3, interior: Dim3) -> torch.Tensor:
    """Interior-shaped view of ``padded`` shifted by ``off`` (x,y,z
    direction vector): element [k,j,i] = padded[k+oz, j+oy, i+ox] in
    interior coordinates. Leading dimensions (an ensemble's member axis,
    ``serving/ensemble.py``) ride along: the last three are (z, y, x)."""
    ox, oy, oz = off
    return padded[..., pad_lo.z + oz:pad_lo.z + oz + interior.z,
                  pad_lo.y + oy:pad_lo.y + oy + interior.y,
                  pad_lo.x + ox:pad_lo.x + ox + interior.x]


def jacobi7(padded: torch.Tensor, radius: Radius,
            interior: Dim3) -> torch.Tensor:
    """7-point Jacobi average: (sum of 6 face neighbors) / 6
    (reference: bin/jacobi3d.cu:65-80). Adds in the JAX version's
    order — x+1, x-1, y+1, y-1, z+1, z-1 — then multiplies by 1/6 in
    the field's dtype, so the two agree bitwise."""
    lo = radius.pad_lo()
    acc = shifted(padded, (1, 0, 0), lo, interior)
    acc = acc + shifted(padded, (-1, 0, 0), lo, interior)
    acc = acc + shifted(padded, (0, 1, 0), lo, interior)
    acc = acc + shifted(padded, (0, -1, 0), lo, interior)
    acc = acc + shifted(padded, (0, 0, 1), lo, interior)
    acc = acc + shifted(padded, (0, 0, -1), lo, interior)
    return acc * sixth(padded.dtype, padded.device)


def laplacian27(padded: torch.Tensor, radius: Radius, interior: Dim3,
                weights=None) -> torch.Tensor:
    """27-point weighted stencil over the radius-1 box (JAX
    ``ops/stencil_kernels.py:46``): it reads the edge and corner halo
    data the 7-point stencil does not. ``weights`` = (centre, face,
    edge, corner), by default the 27-point Laplacian's; the terms are
    added in the JAX version's order (x outermost, then y, then z)."""
    lo = radius.pad_lo()
    if weights is None:
        w_center, w_face = -88.0 / 26.0, 6.0 / 26.0
        w_edge, w_corner = 3.0 / 26.0, 2.0 / 26.0
    else:
        w_center, w_face, w_edge, w_corner = weights
    out = w_center * shifted(padded, (0, 0, 0), lo, interior)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                n = (dx != 0) + (dy != 0) + (dz != 0)
                if n == 0:
                    continue
                w = (w_face, w_edge, w_corner)[n - 1]
                out = out + w * shifted(padded, (dx, dy, dz), lo, interior)
    return out


def central_diff(padded: torch.Tensor, axis: int, radius: Radius,
                 interior: Dim3) -> torch.Tensor:
    """Second-order central difference along grid ``axis`` (0=x, 1=y,
    2=z): ``(p[i+1] - p[i-1]) * 0.5`` over the ``interior`` region — the
    radius-1 gradient component the PIC model's field gather
    interpolates (``models/pic.py`` computes ``E = -grad rho``).
    ``radius`` is the ALLOCATION radius of ``padded``; the slices reach
    one cell past the region along ``axis`` only."""
    lo = radius.pad_lo()
    plus = [0, 0, 0]
    plus[axis] = 1
    minus = [0, 0, 0]
    minus[axis] = -1
    return (shifted(padded, tuple(plus), lo, interior)
            - shifted(padded, tuple(minus), lo, interior)) * 0.5


def sixth(dtype: torch.dtype, device) -> torch.Tensor:
    """1/6 rounded once to ``dtype`` — the ``dt.type(1.0 / 6.0)`` of the
    JAX kernels — as a 0-dim tensor, so the multiply runs in ``dtype``.
    Made by a fill on ``device``: a copy from host memory would wait for
    the card."""
    return torch.full((), 1.0 / 6.0, dtype=dtype, device=device)


def write_interior(padded: torch.Tensor, interior_vals: torch.Tensor,
                   radius: Radius) -> torch.Tensor:
    """Place interior-shaped values into a padded shard, IN PLACE (the
    JAX version returns a new array); halos keep their contents. Both
    may carry the same leading dimensions."""
    lo = radius.pad_lo()
    Z, Y, X = interior_vals.shape[-3:]
    padded[..., lo.z:lo.z + Z, lo.y:lo.y + Y,
           lo.x:lo.x + X].copy_(interior_vals)
    return padded


def global_coords(origin_xyz, interior: Dim3, device=None):
    """(z, y, x) broadcastable int64 global-coordinate tensors for a
    shard's interior (the Accessor "friendly coordinates" analog,
    reference: include/stencil/accessor.hpp:31-45)."""
    ox, oy, oz = origin_xyz
    gz = oz + torch.arange(interior.z, device=device)[:, None, None]
    gy = oy + torch.arange(interior.y, device=device)[None, :, None]
    gx = ox + torch.arange(interior.x, device=device)[None, None, :]
    return gz, gy, gx
