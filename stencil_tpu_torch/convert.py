"""Carry state across from the JAX package.

The systems have no weights: their state is fields. Jacobi's is the
temperature field (the sphere configuration both packages derive from
the grid size); Astaroth's is 8 fields plus the 8 RK3 accumulators
``w``. A JAX domain hands a field over as numpy — the global interior
from ``DistributedDomain.interior_to_host`` or ``Astaroth.field``, or a
(1,1,1) domain's padded shard (``np.asarray(dd.curr[name])``) — and
``field_from_jax`` turns it into the port's halo-padded tensor on a
device; ``interior_from_jax`` checks a global interior for
``DistributedDomain.set_interior``, which scatters it into the shards
of any mesh; ``astaroth_state_from_jax`` does so for a whole MHD state.
Nothing here imports JAX: the two packages meet only in numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .distributed import DeviceLike, resolve_device, torch_dtype
from .geometry import Dim3, Radius
from .local_domain import interior_slices, raw_size, zyx_shape


def field_from_jax(arr: np.ndarray, radius: Radius, layout: str = "padded",
                   device: DeviceLike = None,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A halo-padded (z,y,x) tensor on ``device`` holding ``arr``.

    ``layout="padded"``: ``arr`` is a padded shard allocated with
    ``radius``; it is copied as it is, halos included.
    ``layout="interior"``: ``arr`` is the global interior; the halos of
    the result are zero, as after ``DistributedDomain.set_interior``.
    ``dtype`` (default: ``arr``'s) must match ``arr``'s exactly — the
    state is carried bit for bit, never converted.
    """
    arr = np.asarray(arr)
    want = torch_dtype(arr.dtype)
    if dtype is not None and torch_dtype(dtype) != want:
        raise TypeError(f"field dtype {arr.dtype} does not match "
                        f"{dtype}; convert explicitly before loading")
    dev = resolve_device(device)
    host = torch.tensor(arr)     # a copy, also of a read-only array
    if layout == "padded":
        return host.to(dev)
    if layout != "interior":
        raise ValueError(f"layout must be 'padded' or 'interior', got "
                         f"{layout!r}")
    Z, Y, X = arr.shape
    size = Dim3(X, Y, Z)
    out = torch.zeros(zyx_shape(raw_size(size, radius)), dtype=want,
                      device=dev)
    out[interior_slices(size, radius)].copy_(host)
    return out


def interior_from_jax(arr: np.ndarray,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A global (z,y,x) interior as a host tensor (a copy), for
    ``DistributedDomain.set_interior``; ``dtype`` (default: ``arr``'s)
    must match ``arr``'s exactly — the state is carried bit for bit."""
    arr = np.asarray(arr)
    if dtype is not None and torch_dtype(dtype) != torch_dtype(arr.dtype):
        raise TypeError(f"field dtype {arr.dtype} does not match "
                        f"{dtype}; convert explicitly before loading")
    return torch.tensor(arr)


def astaroth_state_from_jax(fields: Dict[str, np.ndarray],
                            w: Optional[Dict[str, np.ndarray]] = None,
                            device: DeviceLike = None,
                            dtype: Optional[torch.dtype] = None
                            ) -> Tuple[Dict[str, torch.Tensor],
                                       Optional[Dict[str, torch.Tensor]]]:
    """The port's MHD state from the JAX model's: ``fields[q]`` are the
    (z,y,x) interiors of its ``field(q)``, ``w[q]`` its ``_w``
    accumulators (interior-shaped; None before its first step). Returns
    ``({q: radius-3 padded field with zero halos}, {q: w tensor} or
    None)`` on ``device``, bit for bit; ``dtype``, if given, must match
    the arrays'."""
    from .models.astaroth import FIELDS

    if set(fields) != set(FIELDS) or (w is not None and set(w) != set(FIELDS)):
        raise ValueError(f"an Astaroth state holds exactly {FIELDS}")
    radius = Radius.constant(3)
    out = {q: field_from_jax(fields[q], radius, layout="interior",
                             device=device, dtype=dtype) for q in FIELDS}
    if w is None:
        return out, None
    wt = {}
    for q in FIELDS:
        arr = np.asarray(w[q])
        if arr.shape != np.asarray(fields[q]).shape:
            raise ValueError(f"w[{q!r}] has shape {arr.shape}, expected the "
                             f"interior's {np.asarray(fields[q]).shape}")
        if torch_dtype(arr.dtype) != out[q].dtype:
            raise TypeError(f"w[{q!r}] is {arr.dtype}, the fields "
                            f"{out[q].dtype}; convert explicitly first")
        wt[q] = torch.tensor(arr, device=out[q].device)
    return out, wt
