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
of any mesh; ``astaroth_state_from_jax`` cuts a whole MHD state into
the shards of a mesh.
Nothing here imports JAX: the two packages meet only in numpy arrays.
numpy has no bfloat16: a JAX bfloat16 array (an ml_dtypes array on the
JAX side) comes across as its ``uint16`` bits (``arr.view(np.uint16)``)
or as the float32 array of its values, and becomes a bfloat16 tensor
when the target dtype is bfloat16 (``tensor_from_jax``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

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
    state is carried bit for bit, never converted —, bfloat16 as
    ``tensor_from_jax`` takes it.
    """
    arr = np.asarray(arr)
    dev = resolve_device(device)
    host = tensor_from_jax(arr, dtype)   # a copy, also of a read-only array
    want = host.dtype
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


def tensor_from_jax(arr: np.ndarray,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host tensor (a copy) of a JAX array handed over as numpy, bit
    for bit: ``dtype`` (default: ``arr``'s) must match ``arr``'s, except
    that a bfloat16 target takes ``uint16`` bits, or float32 values that
    bfloat16 holds exactly."""
    arr = np.asarray(arr)
    if dtype is not None and torch_dtype(dtype) == torch.bfloat16:
        if arr.dtype == np.uint16:
            return torch.from_numpy(arr.copy()).view(torch.int16).view(
                torch.bfloat16)
        if arr.dtype == np.float32:
            out = torch.from_numpy(arr.copy()).to(torch.bfloat16)
            if not torch.equal(out.float(), torch.from_numpy(arr)):
                raise TypeError("float32 values that bfloat16 does not hold "
                                "exactly; convert explicitly before loading")
            return out
    if dtype is not None and torch_dtype(dtype) != torch_dtype(arr.dtype):
        raise TypeError(f"field dtype {arr.dtype} does not match "
                        f"{dtype}; convert explicitly before loading")
    return torch.tensor(arr)


def interior_from_jax(arr: np.ndarray,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A global (z,y,x) interior as a host tensor (a copy), for
    ``DistributedDomain.set_interior``; ``dtype`` (default: ``arr``'s)
    must match ``arr``'s exactly, bfloat16 as ``tensor_from_jax`` takes
    it — the state is carried bit for bit."""
    return tensor_from_jax(arr, dtype)


def _scatter(values: torch.Tensor, domain, radius: Optional[Radius]
             ) -> List[torch.Tensor]:
    """A global (z,y,x) interior cut into ``domain``'s shards on their
    devices, each at capacity: padded by ``radius`` (zero halos), or
    unpadded with ``radius=None``; a short shard's dead rows are zero."""
    shards = []
    for i, dev in enumerate(domain.mesh.devices):
        sz, org = domain.shard_size(i), domain.shard_origin(i)
        cap = (raw_size(domain.local_size, radius) if radius is not None
               else domain.local_size)
        out = torch.zeros(zyx_shape(cap), dtype=values.dtype, device=dev)
        dst = (out[interior_slices(sz, radius)] if radius is not None
               else out[:sz.z, :sz.y, :sz.x])
        dst.copy_(values[org.z:org.z + sz.z, org.y:org.y + sz.y,
                         org.x:org.x + sz.x])
        shards.append(out)
    return shards


def _blocks(values: torch.Tensor, domain) -> List[torch.Tensor]:
    """A global array of equal per-shard blocks (JAX's layout of a
    sharded array, the block of mesh position (x, y, z) at block index
    (z, y, x)) cut into ``domain``'s shards on their devices."""
    c = domain.mesh_counts
    bz, by, bx = (values.shape[0] // c.z, values.shape[1] // c.y,
                  values.shape[2] // c.x)
    out = []
    for i, dev in enumerate(domain.mesh.devices):
        m = domain.shard_index(i)
        out.append(values[m.z * bz:(m.z + 1) * bz, m.y * by:(m.y + 1) * by,
                          m.x * bx:(m.x + 1) * bx].to(dev).clone())
    return out


def astaroth_state_from_jax(fields: Dict[str, np.ndarray],
                            w: Optional[Dict[str, np.ndarray]], domain,
                            dtype: Optional[torch.dtype] = None):
    """The port's MHD state from the JAX model's: ``fields[q]`` are the
    global (z,y,x) interiors of its ``field(q)``, ``w[q]`` its ``_w``
    accumulators (None before its first step): interior-shaped, or, from
    JAX's temporal path, padded — a global array of one ``raw_size(local,
    alloc_radius)`` block per mesh position. Returns ``({q: [shard]}, {q:
    [shard]} or None)``: the shards (x fastest) of ``domain``, a realized
    ``DistributedDomain``, on their devices, each at capacity — the field
    padded at ``domain.alloc_radius`` with zero halos, and w unpadded, or
    padded as given; a short shard's dead rows are zero. Bit for bit;
    ``dtype``, if given, must match the arrays' (bfloat16 as
    ``tensor_from_jax`` takes it)."""
    from .models.astaroth import FIELDS

    if set(fields) != set(FIELDS) or (w is not None and set(w) != set(FIELDS)):
        raise ValueError(f"an Astaroth state holds exactly {FIELDS}")
    radius = domain.alloc_radius
    shape = zyx_shape(domain.size)
    padded = zyx_shape(raw_size(domain.local_size, radius)
                       * domain.mesh_counts)
    out = {}
    for q in FIELDS:
        t = interior_from_jax(fields[q], dtype)
        if tuple(t.shape) != shape:
            raise ValueError(f"fields[{q!r}] has shape {tuple(t.shape)}, "
                             f"expected the domain's {shape}")
        out[q] = _scatter(t, domain, radius)
    if w is None:
        return out, None
    wt = {}
    for q in FIELDS:
        arr = np.asarray(w[q])
        if arr.shape not in (shape, padded):
            raise ValueError(f"w[{q!r}] has shape {arr.shape}, expected the "
                             f"interior's {shape} or the padded {padded}")
        want = out[q][0].dtype
        try:
            t = tensor_from_jax(arr, want)
        except TypeError:
            raise TypeError(f"w[{q!r}] is {arr.dtype}, the fields {want}; "
                            f"convert explicitly first") from None
        wt[q] = (_scatter(t, domain, None) if arr.shape == shape
                 else _blocks(t, domain))
    return out, wt


def pic_state_from_jax(state: Dict[str, np.ndarray], domain, capacity: int,
                       dtype: Optional[torch.dtype] = None
                       ) -> Dict[str, List[torch.Tensor]]:
    """The port's PIC state from the JAX model's ``Pic.state`` handed over
    as numpy (``{k: np.asarray(v)}``): each particle lane (``x`` .. ``q``,
    ``valid``) a global array of one ``capacity`` block per mesh position
    (z outermost, x fastest: the port's shard order), ``overflow`` one
    count per mesh position, and ``rho`` the padded global array, one
    ``raw_size(local, alloc_radius)`` block per mesh position. Returns
    ``{key: [shard tensor]}`` on ``domain``'s devices, for
    ``Pic.load_state``, bit for bit; ``dtype``, if given, must match the
    particle lanes' and rho's."""
    from .models.pic import PARTICLE_FIELDS

    n = domain.mesh_counts.flatten()
    missing = set(PARTICLE_FIELDS + ("valid", "overflow", "rho")) - set(state)
    if missing:
        raise ValueError(f"a PIC state lacks {sorted(missing)}")
    padded = zyx_shape(raw_size(domain.local_size, domain.alloc_radius)
                       * domain.mesh_counts)
    rho = tensor_from_jax(np.asarray(state["rho"]), dtype)
    if tuple(rho.shape) != padded:
        raise ValueError(f"rho has shape {tuple(rho.shape)}, expected the "
                         f"padded {padded}")
    out = {"rho": _blocks(rho, domain)}
    devs = domain.mesh.devices
    for k in PARTICLE_FIELDS + ("valid", "overflow"):
        arr = np.asarray(state[k])
        per = 1 if k == "overflow" else int(capacity)
        if arr.shape != (n * per,):
            raise ValueError(f"{k} has shape {arr.shape}, expected "
                             f"({n * per},)")
        t = (torch.from_numpy(arr.astype(np.float32)) if k == "overflow"
             else torch.from_numpy(arr.copy()) if k == "valid"
             else tensor_from_jax(arr, rho.dtype))
        out[k] = [t[i * per:(i + 1) * per].to(devs[i]).clone()
                  for i in range(n)]
    return out
