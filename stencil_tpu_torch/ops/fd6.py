"""6th-order central finite-difference operators on padded shards.

PyTorch-port counterpart of ``stencil_tpu/ops/fd6.py`` (reference:
astaroth/user_kernels.h:36-121 first/second/cross_derivative): each
operator is a sum of shifted interior-shaped slices of the padded
(z,y,x) tensor. Every term is formed and added in the JAX module's
order, and each coefficient is rounded once to the field's dtype, so
the two packages compute the same values.

Coefficients (6th-order central):
* 1st derivative: (3/4, -3/20, 1/60) antisymmetric pairs / ds
* 2nd derivative: -49/18 center + (3/2, -3/20, 1/90) symmetric / ds^2
* cross derivative: (270, -27, 2)/720 over the two diagonals
  (reference: user_kernels.h:66-76) — needs edge halo data of the same
  radius, i.e. Radius.constant(3), the reference's STENCIL_ORDER 6
  (astaroth/astaroth.h:8-9).

Axis convention: axis 0=x, 1=y, 2=z (grid order); tensors are (z,y,x),
with any leading dimensions riding along (an ensemble's member axis).
``x_wrap=True``: the tensor carries no x padding and spans the whole
periodic x extent; a +ox shift is ``torch.roll(w, -ox, -1)`` (the JAX
module's in-kernel ``pltpu.roll``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..geometry import Dim3

# 6th-order coefficient tables
_D1 = (3.0 / 4.0, -3.0 / 20.0, 1.0 / 60.0)
_D2_C = -49.0 / 18.0
_D2 = (3.0 / 2.0, -3.0 / 20.0, 1.0 / 90.0)
_DC = (270.0 / 720.0, -27.0 / 720.0, 2.0 / 720.0)

RADIUS = 3


def const(v, dtype: torch.dtype) -> torch.Tensor:
    """``v`` rounded once to ``dtype`` — the ``jnp.asarray(v, dtype)``
    of the JAX code — as a 0-dim CPU tensor. PyTorch takes a 0-dim CPU
    tensor as a scalar operand on any device, so the arithmetic runs in
    ``dtype`` and no constant is copied to the card. A tensor ``v`` (an
    ensemble's per-member coefficients, ``(N, 1, 1, 1)`` on the shard's
    device) is cast to ``dtype`` where it lies."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.tensor(float(v), dtype=dtype)


def _shift(padded: torch.Tensor, off_xyz: Tuple[int, int, int],
           pad_lo: Dim3, interior: Dim3, x_wrap: bool = False
           ) -> torch.Tensor:
    ox, oy, oz = off_xyz
    z0, y0 = pad_lo.z + oz, pad_lo.y + oy
    if x_wrap:
        assert pad_lo.x == 0 and interior.x == padded.shape[-1]
        w = padded[..., z0:z0 + interior.z, y0:y0 + interior.y, :]
        if ox:
            w = torch.roll(w, -ox, -1)
        return w
    x0 = pad_lo.x + ox
    return padded[..., z0:z0 + interior.z, y0:y0 + interior.y,
                  x0:x0 + interior.x]


def _axis_off(axis: int, i: int) -> Tuple[int, int, int]:
    off = [0, 0, 0]
    off[axis] = i
    return tuple(off)


def der1(padded: torch.Tensor, axis: int, inv_ds: float, pad_lo: Dim3,
         interior: Dim3, x_wrap: bool = False) -> torch.Tensor:
    """6th-order first derivative along ``axis``
    (reference: user_kernels.h:36-48 first_derivative + derx/dery/derz)."""
    dt = padded.dtype
    acc = None
    for i, c in enumerate(_D1, start=1):
        hi = _shift(padded, _axis_off(axis, i), pad_lo, interior, x_wrap)
        lo = _shift(padded, _axis_off(axis, -i), pad_lo, interior, x_wrap)
        term = const(c, dt) * (hi - lo)
        acc = term if acc is None else acc + term
    return acc * const(inv_ds, dt)


def der2(padded: torch.Tensor, axis: int, inv_ds: float, pad_lo: Dim3,
         interior: Dim3, x_wrap: bool = False) -> torch.Tensor:
    """6th-order second derivative along ``axis``
    (reference: user_kernels.h:49-62 second_derivative)."""
    dt = padded.dtype
    acc = const(_D2_C, dt) * _shift(padded, (0, 0, 0), pad_lo, interior,
                                    x_wrap)
    for i, c in enumerate(_D2, start=1):
        hi = _shift(padded, _axis_off(axis, i), pad_lo, interior, x_wrap)
        lo = _shift(padded, _axis_off(axis, -i), pad_lo, interior, x_wrap)
        acc = acc + const(c, dt) * (hi + lo)
    return acc * const(inv_ds * inv_ds, dt)


def der_cross(padded: torch.Tensor, axis_a: int, axis_b: int,
              inv_ds_a: float, inv_ds_b: float, pad_lo: Dim3,
              interior: Dim3, x_wrap: bool = False) -> torch.Tensor:
    """6th-order mixed derivative d2/(da db), a != b
    (reference: user_kernels.h:63-76 cross_derivative + derxy/...):
    pencil_a runs along the (+a,+b) diagonal, pencil_b along (+a,-b)."""
    dt = padded.dtype

    def at(sa: int, sb: int) -> torch.Tensor:
        off = [0, 0, 0]
        off[axis_a] = sa
        off[axis_b] = sb
        return _shift(padded, tuple(off), pad_lo, interior, x_wrap)

    acc = None
    for i, c in enumerate(_DC, start=1):
        term = const(c, dt) * (at(i, i) + at(-i, -i) - at(i, -i)
                               - at(-i, i))
        acc = term if acc is None else acc + term
    return acc * const(inv_ds_a * inv_ds_b, dt)


def value(padded: torch.Tensor, pad_lo: Dim3, interior: Dim3,
          x_wrap: bool = False) -> torch.Tensor:
    """Center value (interior view)."""
    return _shift(padded, (0, 0, 0), pad_lo, interior, x_wrap)


class FieldData:
    """value + gradient + hessian of one scalar field, computed lazily
    and cached — the AcRealData analog (reference: user_kernels.h:19-23,
    read_data). ``inv_ds`` is (1/dsx, 1/dsy, 1/dsz)."""

    def __init__(self, padded: torch.Tensor,
                 inv_ds: Tuple[float, float, float], pad_lo: Dim3,
                 interior: Dim3, x_wrap: bool = False) -> None:
        self._p = padded
        self._inv = inv_ds
        self._lo = pad_lo
        self._n = interior
        self._xw = x_wrap
        self._cache = {}

    @property
    def value(self) -> torch.Tensor:
        return self._get(("v",), lambda: value(self._p, self._lo, self._n,
                                               self._xw))

    def grad(self, axis: int) -> torch.Tensor:
        return self._get(("g", axis), lambda: der1(
            self._p, axis, self._inv[axis], self._lo, self._n, self._xw))

    @property
    def gradient(self):
        return tuple(self.grad(a) for a in range(3))

    def hess(self, a: int, b: int) -> torch.Tensor:
        if a > b:
            a, b = b, a
        if a == b:
            return self._get(("h", a, a), lambda: der2(
                self._p, a, self._inv[a], self._lo, self._n, self._xw))
        return self._get(("h", a, b), lambda: der_cross(
            self._p, a, b, self._inv[a], self._inv[b], self._lo, self._n,
            self._xw))

    @property
    def laplace(self) -> torch.Tensor:
        return self.hess(0, 0) + self.hess(1, 1) + self.hess(2, 2)

    def _get(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]
