"""Astaroth-parity MHD integrator over a mesh of shards: 8 fields, 6th
order, RK3.

PyTorch-port counterpart of ``stencil_tpu/models/astaroth.py``
(reference: astaroth/astaroth.cu, "rough approximation of astaroth
using the stencil library"): 8 scalar fields — lnrho, uu(x,y,z),
aa(x,y,z), entropy — advanced by a Williamson (1980) 3-step low-storage
Runge-Kutta (astaroth/integration.cuh:14-38) with 6th-order central and
cross derivatives (radius 3) and periodic boundaries. The physics
(``mhd_rates``, reference: astaroth/user_kernels.h:383-453) is the JAX
module's expression for expression.

The grid is split over a mesh of shards (``mesh_shape``, ``devices``;
see ``distributed.py``). Compute paths (``kernel=``), as in the JAX
model:

* ``wrap`` — the one-shard fast path. The interiors stay resident in
  one (8, Z, Y, X) tensor between calls (extracted once, written back on
  ``sync_domain()``); one iteration is three launches of the fused
  substep kernel B9 (``mhd_substep_wrap_cuda``): substep 0 with
  ``w=None``, substep 1, substep 2 with ``write_w=False``. With
  ``STENCIL_MHD_PAIR=1`` it is one call of the pair B10
  (``mhd_substep01_wrap_cuda``: B9 s=0 and s=1 in one call) and B9 for
  substep 2. The carried ``w``
  is the last one written, as in JAX. B9, B11 and B13's interior are
  one z-streaming kernel (``csrc/mhd_ring.cuh``), launched over the
  whole field, the whole shard, or the shard's interior.
* ``halo`` — the multi-shard fast path on an x-unsharded mesh, (1,1,1)
  included: the same resident state per shard, and before every launch
  one slab round over ALL shards (``exchange_interior_slabs``, the 8
  fields of a shard moved by each slice), then B11
  (``mhd_substep_halo_cuda``) per shard, three times an iteration; with
  the pair (``STENCIL_MHD_PAIR=1`` or ``exchange_every=2``) one
  radius-2R round and B12 (``mhd_substep01_halo_cuda``), then a
  radius-R round and B11 for substep 2.
* ``halo-overlap`` — ``overlap=True`` with ``kernel="halo"``, or
  ``auto`` on CUDA devices, on an x-unsharded mesh of even
  shards, (1,1,1) included: the halo path's resident state, with each
  substep's slab round moved into the kernels (``ops/cuda_mhd_overlap.py``
  ``mhd_substep_overlap``): per shard B13 stores its boundary rows of all
  8 fields into its neighbours' receive buffers and computes its
  interior, then B14 computes the exterior shell from the landed rows —
  equal to ``halo`` bitwise. With the pair: the pair pass (substeps 0+1,
  2R rows), then substep 2.
* ``xla`` — per substep: exchange into the radius-3 padded shards, then
  per shard ``FieldData`` + ``mhd_rates`` + the RK update in plain
  PyTorch, written into the shard in place. The port's reference path;
  no kernel. It runs on any mesh, uneven (+-1) shards included. The
  exchange runs by ``methods`` (``Method.PallasDMA``: B4).
* ``xla-overlap`` — ``overlap=True`` where ``halo-overlap`` is not
  taken: the ``xla`` update over ``parallel/overlap.py``'s
  interior/exterior split, the inner blocks computed while the exchange
  runs (JAX's ``substep_overlap``).
* ``xla-temporal[s=N]`` (``-overlap``) — ``exchange_every=N >= 2`` off
  the kernel paths (JAX's ``_build_temporal_xla_step``): RK substeps in
  groups of N through ``parallel/temporal.py``, one depth-3N exchange a
  group, over periods of ``lcm(3, N)`` substeps, so that every group's
  RK phase is fixed; a group that starts where alpha != 0 ships the
  padded ``w`` accumulators in the same exchange. ``overlap=True``
  splits a deep group's first substep around the exchange.
* ``auto`` — on CUDA devices for float32 and bfloat16: ``halo-overlap``
  when overlap is asked for and possible, else ``wrap`` on a (1,1,1)
  mesh, else ``halo`` when x is unsharded and the shards are even with z
  and y multiples of ``mhd_tile`` (8; 16 for bfloat16), else ``xla``;
  ``xla`` on the CPU, as the JAX model takes ``xla`` off the TPU. The
  JAX model's ``auto`` also asks its TPU block planner whether the halo
  kernel's VMEM window fits the shard (it does not for float32 shards
  wider than x ~ 166); the CUDA kernels have no such window, so the port
  does not ask.

The kernel paths run periodic boundaries and ``exchange_every`` <= 2
(2 is the substep pair on the halo paths; on ``wrap`` it has no
effect). ``boundary=Boundary.NONE`` (a zero-Dirichlet exterior) runs
the ``xla`` paths. bfloat16 fields are stored in bfloat16 and computed
in float32 on every path (``ops/cuda_mhd.compute_dtype``); ``field`` and
``accumulator`` hand them out as float32 arrays. On the CPU the kernel
wrappers run their plain twins.

A mesh may span processes (``distributed.py``): every rank builds the
same model and runs its own shards, on every path: ``xla``,
``xla-overlap``, ``xla-temporal`` and ``halo`` (B11, and B12 with the
pair) move the slabs that cross between ranks as messages,
``halo-overlap`` (B13/B14) and ``PallasDMA`` (B4) store into the other
ranks' buffers through CUDA IPC on the card (on CPU shards their twins
send messages), and ``field`` and ``accumulator`` are collectives.
``dcn_axis`` / ``dcn_groups`` block one grid axis across hosts, with
JAX's x-unsharded mesh for the halo paths (``models/astaroth.py:
249-266``).

``make_segment(k)`` (``parallel/megastep.py``) runs ``k`` iterations of
the ``xla`` paths with ``w`` carried and a health-probe row on the
device after each chunk; the kernel paths keep their state outside
``dd.curr`` and decline, as JAX's do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed import DeviceLike, DistributedDomain, torch_dtype
from ..geometry import Dim3, Dim3Like, Radius
from ..local_domain import interior_slices, zyx_shape
from ..local_domain import raw_size
from ..ops.fd6 import RADIUS, FieldData, const
from ..ops.stencil_kernels import global_coords
from ..parallel.exchange import exchange_interior_slabs, interior_slab_bytes
from ..parallel.methods import Method, pick_method
from ..parallel.overlap import overlapped_update
from ..parallel.temporal import temporal_shard_steps, validate_temporal
from ..partition import partition_dims_even_xfree
from ..topology import Boundary
from ..utils.config import load_config, mhd_pair_requested
from ..utils.logging import LOG_INFO, LOG_WARN
from ..utils.timers import device_sync

FIELDS = ("lnrho", "uux", "uuy", "uuz", "ax", "ay", "az", "ss")

Fields = Dict[str, torch.Tensor]

# Williamson (1980) low-storage RK3 (reference: integration.cuh:20-21)
RK3_ALPHA = (0.0, -5.0 / 9.0, -153.0 / 128.0)
RK3_BETA = (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0)


@dataclasses.dataclass
class MhdParams:
    """Physical constants (reference: astaroth/astaroth.conf defaults)."""

    dsx: float = 0.04908738521
    dsy: float = 0.04908738521
    dsz: float = 0.04908738521
    dt: float = 1e-8            # astaroth.cu:578 loads AC_dt = 1e-8
    nu_visc: float = 5e-3
    cs_sound: float = 1.0
    zeta: float = 0.01
    eta: float = 5e-3
    mu0: float = 1.4
    cp_sound: float = 1.0
    gamma: float = 0.5
    lnT0: float = 1.2
    lnrho0: float = 1.3

    @property
    def cs2_sound(self) -> float:
        return self.cs_sound * self.cs_sound

    @classmethod
    def from_conf(cls, path: str) -> "MhdParams":
        """Load from an astaroth.conf-style file (reference:
        astaroth/astaroth_utils.cu acLoadConfig)."""
        ints, reals = load_config(path)
        m = {"AC_dsx": "dsx", "AC_dsy": "dsy", "AC_dsz": "dsz",
             "AC_dt": "dt", "AC_nu_visc": "nu_visc",
             "AC_cs_sound": "cs_sound", "AC_zeta": "zeta", "AC_eta": "eta",
             "AC_mu0": "mu0", "AC_cp_sound": "cp_sound",
             "AC_gamma": "gamma", "AC_lnT0": "lnT0", "AC_lnrho0": "lnrho0"}
        kw = {}
        for src, dst in m.items():
            if src in reals:
                kw[dst] = reals[src]
            elif src in ints:
                kw[dst] = float(ints[src])
        return cls(**kw)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def mhd_rates(f: Dict[str, FieldData], prm: MhdParams, dtype):
    """Right-hand sides of all 8 equations at the current state
    (reference: astaroth/user_kernels.h:383-453). ``dtype`` is the
    compute dtype: every constant is rounded once to it."""

    def c(v):
        return const(v, dtype)

    lnrho, ss = f["lnrho"], f["ss"]
    uu = (f["uux"], f["uuy"], f["uuz"])
    aa = (f["ax"], f["ay"], f["az"])

    u = tuple(q.value for q in uu)
    grad_lnrho = lnrho.gradient
    grad_ss = ss.gradient

    div_u = uu[0].grad(0) + uu[1].grad(1) + uu[2].grad(2)

    # continuity (user_kernels.h continuity)
    d_lnrho = -_dot(u, grad_lnrho) - div_u

    # traceless rate-of-strain tensor S (user_kernels.h stress_tensor)
    third = c(1.0 / 3.0)
    S = [[None] * 3 for _ in range(3)]
    S[0][0] = c(2.0 / 3.0) * uu[0].grad(0) - third * (uu[1].grad(1) + uu[2].grad(2))
    S[1][1] = c(2.0 / 3.0) * uu[1].grad(1) - third * (uu[0].grad(0) + uu[2].grad(2))
    S[2][2] = c(2.0 / 3.0) * uu[2].grad(2) - third * (uu[0].grad(0) + uu[1].grad(1))
    S[0][1] = S[1][0] = c(0.5) * (uu[0].grad(1) + uu[1].grad(0))
    S[0][2] = S[2][0] = c(0.5) * (uu[0].grad(2) + uu[2].grad(0))
    S[1][2] = S[2][1] = c(0.5) * (uu[1].grad(2) + uu[2].grad(1))

    # current j = (1/mu0)(grad div A - lap A); B = curl A
    grad_div_a = tuple(
        aa[0].hess(i, 0) + aa[1].hess(i, 1) + aa[2].hess(i, 2)
        for i in range(3))
    lap_a = tuple(q.laplace for q in aa)
    inv_mu0 = c(1.0 / prm.mu0)
    j = tuple(inv_mu0 * (grad_div_a[i] - lap_a[i]) for i in range(3))
    B = (aa[2].grad(1) - aa[1].grad(2),
         aa[0].grad(2) - aa[2].grad(0),
         aa[1].grad(0) - aa[0].grad(1))

    # induction (user_kernels.h induction)
    u_x_B = _cross(u, B)
    d_aa = tuple(u_x_B[i] + c(prm.eta) * lap_a[i] for i in range(3))

    # momentum (user_kernels.h momentum)
    cs2 = c(prm.cs2_sound) * torch.exp(
        c(prm.gamma / prm.cp_sound) * ss.value
        + c(prm.gamma - 1.0) * (lnrho.value - c(prm.lnrho0)))
    inv_rho = torch.exp(-lnrho.value)
    adv = tuple(_dot((uu[i].grad(0), uu[i].grad(1), uu[i].grad(2)), u)
                for i in range(3))
    grad_div_u = tuple(
        uu[0].hess(i, 0) + uu[1].hess(i, 1) + uu[2].hess(i, 2)
        for i in range(3))
    lap_u = tuple(q.laplace for q in uu)
    j_x_B = _cross(j, B)
    S_dot_glnrho = tuple(_dot(S[i], grad_lnrho) for i in range(3))
    d_uu = tuple(
        -adv[i]
        - cs2 * (c(1.0 / prm.cp_sound) * grad_ss[i] + grad_lnrho[i])
        + inv_rho * j_x_B[i]
        + c(prm.nu_visc) * (lap_u[i] + third * grad_div_u[i]
                            + c(2.0) * S_dot_glnrho[i])
        + c(prm.zeta) * grad_div_u[i]
        for i in range(3))

    # entropy (user_kernels.h entropy, lnT, heat_conduction)
    lnT = (c(prm.lnT0) + c(prm.gamma / prm.cp_sound) * ss.value
           + c(prm.gamma - 1.0) * (lnrho.value - c(prm.lnrho0)))
    rho = torch.exp(lnrho.value)
    inv_pT = torch.exp(-lnrho.value - lnT)
    contract_S = sum(S[i][k] * S[i][k] for i in range(3) for k in range(3))
    rhs = (c(prm.eta * prm.mu0) * _dot(j, j)
           + c(2.0 * prm.nu_visc) * rho * contract_S
           + c(prm.zeta) * rho * div_u * div_u)
    # heat conduction with chi = 0.001/(rho cp) (user_kernels.h:441-449)
    inv_cp = c(1.0 / prm.cp_sound)
    gamma_ = c(prm.gamma)
    first_term = gamma_ * inv_cp * ss.laplace + (gamma_ - c(1.0)) * lnrho.laplace
    second = tuple(gamma_ * inv_cp * grad_ss[i] + (gamma_ - c(1.0)) * grad_lnrho[i]
                   for i in range(3))
    third_t = tuple(gamma_ * (inv_cp * grad_ss[i] + grad_lnrho[i])
                    - grad_lnrho[i] for i in range(3))
    chi = c(0.001) * torch.exp(-lnrho.value) * inv_cp
    heat = c(prm.cp_sound) * chi * (first_term + _dot(second, third_t))
    d_ss = -_dot(u, grad_ss) + inv_pT * rhs + heat

    return {"lnrho": d_lnrho, "uux": d_uu[0], "uuy": d_uu[1], "uuz": d_uu[2],
            "ax": d_aa[0], "ay": d_aa[1], "az": d_aa[2], "ss": d_ss}


def mhd_substep_shard(curr: Dict[str, torch.Tensor],
                      w: Dict[str, torch.Tensor], s: int, prm: MhdParams,
                      dtype: torch.dtype, radius: Radius, local: Dim3,
                      alloc_radius: Radius) -> None:
    """RK3 substep ``s`` on one exchanged padded shard: the rates and the
    update ``wq = alpha*w + dt*rates; u = value + beta*wq`` over its
    capacity interior (the JAX model's ``substep_fused``), written into
    ``curr`` in place, with ``w[q]`` replaced by the new accumulator.
    Leading dimensions (an ensemble's member axis) broadcast, and so do
    ``prm``'s coefficients where they are ``(N, 1, 1, 1)`` tensors."""
    from ..ops.cuda_mhd import compute_dtype

    comp = compute_dtype(dtype)
    pad_lo = radius.pad_lo()
    inv_ds = (1.0 / prm.dsx, 1.0 / prm.dsy, 1.0 / prm.dsz)
    alpha = const(RK3_ALPHA[s], comp)
    beta = const(RK3_BETA[s], comp)
    dt_ = const(prm.dt, comp)
    cap = (Ellipsis,) + interior_slices(local, alloc_radius)
    data = {q: FieldData(t.to(comp), inv_ds, pad_lo, local)
            for q, t in curr.items()}
    rates = mhd_rates(data, prm, comp)
    for q in curr:
        wq = alpha * w[q].to(comp) + dt_ * rates[q]
        uq = data[q].value + beta * wq
        w[q] = wq.to(dtype)
        curr[q][cap].copy_(uq)


def _host_values(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A float64 initial-condition array as a host tensor of ``dtype``,
    rounded as the JAX model's ``astype`` rounds it: numpy for float32
    and float64; for bfloat16 through float32 first, as ml_dtypes
    rounds a float64."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.astype(torch.empty((), dtype=dtype).numpy()
                                      .dtype))


def _views(t: torch.Tensor) -> Fields:
    """The 8 fields of a (8, Z, Y, X) state tensor, as contiguous
    views in FIELDS order."""
    return dict(zip(FIELDS, t.unbind(0)))


def select_kernel_path(kernel: str, overlap: bool, counts: Dim3, rem: Dim3,
                       local: Dim3, tile: int, accel: bool,
                       exchange_every: int = 1,
                       nonperiodic: bool = False) -> str:
    """The compute path ``Astaroth`` builds: JAX's selection rules
    (models/astaroth.py:411-527) without its VMEM planner; ``accel``
    (CUDA devices, float32 or bfloat16) stands for JAX's on-TPU choice
    (``_fast_dtype_ok``). The kernel paths take periodic boundaries and
    ``exchange_every`` 1 or 2 (``halo``, ``halo-overlap``; ``wrap`` any);
    deeper blocking off them is ``xla-temporal[s=N]``. Raises as JAX
    does for an uneven grid with overlap and for an explicit kernel its
    conditions exclude."""
    if overlap and rem != Dim3(0, 0, 0):
        raise NotImplementedError("overlap mode requires an evenly "
                                  "divisible grid")
    aligned_t = (rem == Dim3(0, 0, 0) and local.z % tile == 0
                 and local.y % tile == 0)
    aligned = aligned_t and not overlap
    kernel_s_ok = exchange_every in (1, 2) and not nonperiodic
    wrap_ok = counts == Dim3(1, 1, 1) and aligned and not nonperiodic
    halo_ok = counts.x == 1 and aligned and kernel_s_ok
    if (overlap and counts.x == 1 and aligned_t and kernel_s_ok
            and (kernel == "halo" or (kernel == "auto" and accel))):
        return "halo-overlap"
    if kernel == "auto":
        kernel = ("xla" if not accel else "wrap" if wrap_ok
                  else "halo" if halo_ok else "xla")
    if kernel == "wrap" and not wrap_ok:
        raise ValueError(
            "kernel='wrap' needs a (1,1,1) mesh, even grid, z/y "
            f"multiples of the dtype sublane tile ({tile}), overlap off")
    if kernel == "halo" and not halo_ok:
        raise ValueError(
            "kernel='halo' needs an x-unsharded mesh, even grid, local z/y "
            f"multiples of the dtype sublane tile ({tile}), overlap off, "
            "periodic boundaries, exchange_every <= 2")
    if kernel == "xla" and exchange_every > 1:
        return (f"xla-temporal[s={exchange_every}]"
                + ("-overlap" if overlap else ""))
    return "xla-overlap" if kernel == "xla" and overlap else kernel


class Astaroth:
    """MHD integrator over a mesh of shards (one device by default:
    ``device=``; a mesh: ``mesh_shape=`` and ``devices=``)."""

    def __init__(self, nx: int, ny: int, nz: int,
                 params: Optional[MhdParams] = None,
                 mesh_shape: Optional[Dim3Like] = None,
                 dtype=torch.float32, overlap: bool = False,
                 kernel: str = "auto",
                 methods: Method = Method.PpermutePacked,
                 exchange_every: Optional[int] = None,
                 boundary: Optional[Boundary] = None,
                 device: DeviceLike = None,
                 devices: Optional[Sequence] = None,
                 dcn_axis=None, dcn_groups=None) -> None:
        from ..ops.cuda_mhd import KERNEL_DTYPES, mhd_tile
        from .jacobi import _dcn_xfree_shape

        if kernel not in ("auto", "wrap", "halo", "xla"):
            raise ValueError(
                f"kernel must be auto|wrap|halo|xla, got {kernel!r}")
        # temporal blocking (JAX models/astaroth.py:235-248): one
        # depth-(s*R) exchange per s RK substeps; the halo paths map s = 2
        # onto their substep pair, the xla path runs xla-temporal
        self._exchange_every = (1 if exchange_every is None
                                else max(int(exchange_every), 1))
        self._dtype = torch_dtype(dtype)
        if self._dtype not in (torch.float32, torch.float64, torch.bfloat16):
            raise TypeError(f"dtype {self._dtype}: Astaroth runs float32, "
                            f"float64 and bfloat16 (stored, computed in "
                            f"float32)")
        self.prm = params or MhdParams()
        self.dd = DistributedDomain(nx, ny, nz, device=device,
                                    devices=devices)
        self.dd.set_radius(Radius.constant(RADIUS))
        self.dd.set_methods(methods)
        # Method.Auto: the kernel paths keep their own substep grouping,
        # only the xla path takes a tuned depth
        self.dd._tune_deep = kernel == "xla" and not overlap
        if self._exchange_every > 1:
            self.dd.set_exchange_every(self._exchange_every)
        if boundary is not None:
            self.dd.set_boundary(boundary)
        dcn = dcn_axis is not None or dcn_groups is not None
        if dcn:
            self.dd.set_dcn_axis(dcn_axis, dcn_groups)
        devs = self.dd._devices
        on_gpu = all(d.type == "cuda" for d in devs)
        if mesh_shape is not None:
            self.dd.set_mesh_shape(mesh_shape)
        elif dcn:
            # the planner does not know that the halo paths need x
            # unsharded (the same rule as Jacobi3D's)
            halo_want = kernel == "halo" or (
                kernel == "auto" and on_gpu and self._dtype in KERNEL_DTYPES)
            shape = _dcn_xfree_shape(Dim3(nx, ny, nz), self.dd._global,
                                     dcn_axis, dcn_groups,
                                     "halo" if halo_want else "xla",
                                     align=mhd_tile(self._dtype))
            if shape is not None:
                self.dd.set_mesh_shape(shape)
        elif len(devs) > 1 and (
                kernel == "halo"
                or (kernel == "auto" and self._dtype in KERNEL_DTYPES
                    and all(d.type == "cuda" for d in devs))):
            # an x-unsharded decomposition, so that the halo path is
            # available (models/astaroth.py:271-288 of the JAX package)
            shape = partition_dims_even_xfree(Dim3(nx, ny, nz), len(devs),
                                              align=mhd_tile(self._dtype))
            if shape is not None:
                self.dd.set_mesh_shape(shape)
        for q in FIELDS:
            self.dd.add_data(q, self._dtype)
        self.dd.realize()
        # a tuned plan may have set the depth
        self._exchange_every = self.dd.exchange_every
        self._kernel = kernel
        self._overlap = bool(overlap)
        # the halo-overlap path's receive buffers and stream ordering,
        # made at its first run
        self._overlap_recv = None
        # RK3 accumulators per shard, capacity-shaped (no halos; padded
        # at the allocation radius on the temporal path, so that its
        # deep exchange can carry them); None until the first iteration
        self._w: Optional[List[Fields]] = None
        # the wrap and halo paths' interior-resident state, one (8, Z, Y,
        # X) tensor per shard (see sync_domain); dd.set_interior flushes
        # it first
        self._inner: Optional[List[torch.Tensor]] = None
        self.dd.on_interior_write(lambda name: self.sync_domain())
        self._build_step()

    # -- initial conditions (reference: astaroth/astaroth.cu:509-528) --
    def init(self) -> None:
        """hash-random all fields in [-1, 1); lnrho constant 0.5;
        radial-explosion shell velocity. The float64 arrays are rounded
        to the storage dtype as the JAX model rounds them
        (``_host_values``)."""
        self._inner = None          # every field is overwritten below
        size = self.dd.size
        shape = zyx_shape(size)
        dtype = self._dtype
        # the reference's hash init has no per-field seed, so all fields
        # get the identical array (astaroth.cu:509-528)
        noise = _host_values(_hash_field(shape), dtype)
        for q in ("ax", "ay", "az", "ss"):
            self.dd.set_interior(q, noise)
        self.dd.set_interior("lnrho",
                             _host_values(np.full(shape, 0.5), dtype))
        ux, uy, uz = _radial_explosion(size, self.prm)
        self.dd.set_interior("uux", _host_values(ux, dtype))
        self.dd.set_interior("uuy", _host_values(uy, dtype))
        self.dd.set_interior("uuz", _host_values(uz, dtype))
        self._w = None

    def load_state(self, fields: Dict[str, np.ndarray],
                   w: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Start from a given state: ``fields[q]`` the global (z,y,x)
        interiors and ``w`` the RK accumulators (or None), as numpy —
        for instance a JAX model's ``field(q)`` and ``_w``, interior-shaped
        or, from its temporal path, padded (see
        ``convert.astaroth_state_from_jax``) — scattered into the
        shards. Carried bit for bit; a padded ``w`` keeps its ring on the
        temporal path and loses it on the others, an interior-shaped one
        gets a zero ring there."""
        from ..convert import astaroth_state_from_jax

        padded, wt = astaroth_state_from_jax(fields, w, self.dd,
                                             dtype=self._dtype)
        self._inner = None
        for q in FIELDS:
            for dst, src in zip(self.dd.curr[q], padded[q]):
                if dst is not None:
                    dst.copy_(src)
        self._w = None
        if wt is not None:
            self._ensure_w()
            cap = self._capacity()
            for i, wi in enumerate(self._w):
                if wi is None:
                    continue
                for q in FIELDS:
                    src = wt[q][i]
                    if src.shape == wi[q].shape:
                        wi[q].copy_(src)
                    elif self._w_padded:
                        wi[q].zero_()
                        wi[q][cap].copy_(src)
                    else:
                        wi[q].copy_(src[cap])

    # -- path selection -------------------------------------------------
    def _build_step(self) -> None:
        """The JAX model's path rules (models/astaroth.py:411-527) without
        its block planner (the GPU kernels have no VMEM window to fit), its
        on-TPU choice taken on CUDA devices for float32 and bfloat16."""
        from ..ops.cuda_mhd import KERNEL_DTYPES, mhd_tile

        dd = self.dd
        fast = self._dtype in KERNEL_DTYPES
        on_gpu = all(d.type == "cuda" for d in dd.mesh.devices)
        s = dd.exchange_every
        nonper = dd.boundary == Boundary.NONE
        kernel = select_kernel_path(self._kernel, self._overlap,
                                    dd.mesh_counts, dd.rem, dd.local_size,
                                    mhd_tile(self._dtype), on_gpu and fast,
                                    exchange_every=s, nonperiodic=nonper)
        if self._kernel == "auto" or kernel != self._kernel:
            LOG_INFO(f"astaroth kernel path: {kernel}")
        if kernel in ("wrap", "halo", "halo-overlap") and not fast and any(
                d.type == "cuda" for d in dd.mesh.devices):
            raise TypeError(f"kernel={kernel!r} runs CUDA kernels that take "
                            f"float32 or bfloat16, got {self._dtype}; use "
                            f"kernel='xla'")
        if kernel == "wrap" and s > 1:
            LOG_WARN("exchange_every has no effect on the single-shard "
                     "wrap path (it performs no exchange); fields still "
                     "carry the deepened allocation pads")
        # the substep pair (B10 / B12, B13/B14 with pair=True):
        # STENCIL_MHD_PAIR=1, or on the halo paths exchange_every=2 (one
        # radius-2R slab round for two substeps)
        self._pair = mhd_pair_requested() or (
            s == 2 and kernel in ("halo", "halo-overlap"))
        if kernel in ("wrap", "halo", "halo-overlap") and self._pair:
            LOG_INFO(f"astaroth {kernel} path: substeps 0+1 as one pair call")
        # the temporal path keeps w padded, so that its ring has a home
        self._w_padded = kernel.startswith("xla-temporal")
        if self._w_padded:
            validate_temporal(dd.radius, dd.local_size, s, dd.rem)
        self._method = pick_method(dd.methods)
        self.kernel_path = kernel
        self._build_segment()

    # -- megastep: campaign segments ------------------------------------
    def _build_segment(self) -> None:
        """The segment builder of the built path (JAX
        models/astaroth.py:548, :756, :1062-1069): a chunk is one
        ``run(c)``: on ``xla`` and ``xla-overlap`` one iteration, on
        ``xla-temporal[s=…]`` a whole ``lcm(3, s)``-period block
        (``lcm(3, s)/3`` iterations, every group's RK phase static, w
        shipped in the deep exchange where a group starts at alpha != 0)
        or a tail iteration of three depth-1 groups. The interior-resident
        kernel paths keep their state in ``self._inner``, outside
        ``dd.curr``, and decline."""
        from ..parallel.megastep import DECLINE_INTERIOR_RESIDENT_STATE

        if self.kernel_path in ("wrap", "halo", "halo-overlap"):
            self._set_segment_decline(
                "interior-resident state (self._inner, one (8, Z, Y, X) "
                "tensor a shard) lives outside dd.curr between the "
                "extract and the insert (sync_domain)",
                code=DECLINE_INTERIOR_RESIDENT_STATE)
        else:
            self._set_segment_builder(
                self.run, math.lcm(3, self.dd.exchange_every) // 3
                if self._w_padded else 1)

    def _set_segment_builder(self, advance_iters, stride: int = 1) -> None:
        """Register the segment factory: the ``(fields, w)`` pair is the
        carry (``dd.curr`` and ``self._w``, advanced in place), the probe
        reads the 8 padded fields after each chunk of
        ``advance_iters(c)`` iterations (``c`` the stride or 1)."""
        from ..parallel import megastep as ms

        def state_fn():
            self._ensure_w()
            return (self.dd.curr, self._w)

        def adopt(out):
            self.dd.curr, self._w = out

        def step(fw, c, i):
            advance_iters(c)
            return (self.dd.curr, self._w)

        self._segment_decline = None
        self._segment_builder = ms.SegmentCompiler(
            self.dd.mesh,
            ms.CarryContract(
                probe_view=lambda fw: {q: fw[0][q] for q in FIELDS},
                stride=stride),
            step, state_fn, adopt)

    def _set_segment_decline(self, reason: str,
                             code: Optional[str] = None) -> None:
        self._segment_builder = None
        self._segment_decline = reason
        self._segment_decline_code = code

    def make_segment(self, check_every: int, probe_every: int = 1,
                     metrics=None):
        """A ``Segment`` advancing ``check_every`` RK3 iterations with
        the health probe kept on the device (``parallel/megastep.py``);
        the ``w`` accumulators are carried with the fields. The
        interior-resident kernel paths return a falsy ``SegmentDecline``
        (code ``interior-resident-state``)."""
        builder = getattr(self, "_segment_builder", None)
        if builder is None:
            from ..parallel import megastep as ms
            reason = (getattr(self, "_segment_decline", None)
                      or "no fused-segment builder for this path")
            code = (getattr(self, "_segment_decline_code", None)
                    or ms.DECLINE_NO_BUILDER)
            return ms.decline("astaroth", self.kernel_path, reason,
                              code=code)
        return builder(int(check_every), max(int(probe_every), 1),
                       metrics)

    # -- stepping -------------------------------------------------------
    def step(self) -> None:
        """One full RK3 iteration (3 substeps)."""
        self.run(1)

    def run(self, iters: int) -> None:
        iters = int(iters)
        if iters <= 0:
            return
        if self.kernel_path in ("wrap", "halo", "halo-overlap"):
            self._run_resident(iters)
            return
        self._ensure_w()
        if self._w_padded:
            self._run_temporal(iters)
            return
        substep = (self._substep_xla_overlap
                   if self.kernel_path == "xla-overlap" else self._substep_xla)
        for _ in range(iters):
            for s in range(3):
                substep(s)

    def _ensure_w(self) -> None:
        if self._w is None:
            size = (raw_size(self.dd.local_size, self.dd.alloc_radius)
                    if self._w_padded else self.dd.local_size)
            own = set(self.dd.mesh.local_positions)
            self._w = [{q: torch.zeros(zyx_shape(size), dtype=self._dtype,
                                       device=d)
                        for q in FIELDS} if i in own else None
                       for i, d in enumerate(self.dd.mesh.devices)]

    def _capacity(self) -> Tuple[slice, slice, slice]:
        return interior_slices(self.dd.local_size, self.dd.alloc_radius)

    def _substep_xla(self, s: int) -> None:
        """One substep on the padded shards: exchange, then per shard
        ``mhd_substep_shard``, written into the shard in place."""
        dd = self.dd
        dd.exchange()
        for i, w in enumerate(self._w):
            if w is None:
                continue
            mhd_substep_shard({q: dd.curr[q][i] for q in FIELDS}, w, s,
                              self.prm, self._dtype, dd.radius,
                              dd.local_size, dd.alloc_radius)

    def _substep_xla_overlap(self, s: int) -> None:
        """``_substep_xla`` with the exchange overlapped
        (``parallel/overlap.py`` ``overlapped_update``; the JAX model's
        ``substep_overlap``): each shard's inner block is updated while
        the exchange runs, its faces from the exchanged shard after it,
        and the update written into the shard in place."""
        from ..ops.cuda_mhd import compute_dtype

        dd = self.dd
        prm = self.prm
        comp = compute_dtype(self._dtype)
        pad_lo = dd.radius.pad_lo()
        inv_ds = (1.0 / prm.dsx, 1.0 / prm.dsy, 1.0 / prm.dsz)
        alpha = const(RK3_ALPHA[s], comp)
        beta = const(RK3_BETA[s], comp)
        dt_ = const(prm.dt, comp)
        ws = self._w

        def upd(blocks, dims, off, i):
            data = {q: FieldData(blocks[q].to(comp), inv_ds, pad_lo, dims)
                    for q in FIELDS}
            rates = mhd_rates(data, prm, comp)
            out = {}
            for q in FIELDS:
                w_blk = ws[i][q][off[2]:off[2] + dims.z,
                                 off[1]:off[1] + dims.y,
                                 off[0]:off[0] + dims.x]
                wq = alpha * w_blk.to(comp) + dt_ * rates[q]
                out[f"w:{q}"] = wq.to(self._dtype)
                out[f"f:{q}"] = (data[q].value + beta * wq).to(self._dtype)
            return out

        cap = self._capacity()
        parts = overlapped_update(dd.curr, dd.radius, dd.mesh_counts,
                                  self._method, upd,
                                  nonperiodic=dd.boundary == Boundary.NONE,
                                  ranks=dd.mesh.peers)
        for i, got in enumerate(parts):
            if got is None:
                continue
            for q in FIELDS:
                ws[i][q] = got[f"w:{q}"]
                dd.curr[q][i][cap].copy_(got[f"f:{q}"])

    def _run_temporal(self, n: int) -> None:
        """JAX's ``_build_temporal_xla_step`` (models/astaroth.py:616-756)
        over the list of shards, in place: RK substeps in groups of ``s =
        exchange_every``, each group one depth-``s*R`` exchange then ``s``
        substeps on the shrinking windows (``temporal_shard_steps``), group
        ``g`` of a period starting at substep ``(g*s) % 3``; ``n //
        (lcm(3, s)/3)`` whole periods, then ``n % (lcm(3, s)/3)`` tail
        iterations of three depth-1 groups, all on the ``s*R``-padded
        buffers. ``w`` is padded too and read pointwise, at the window
        centre of its base-radius-padded block; a deep group whose first
        substep has alpha != 0 ships it in the same exchange. With
        ``Boundary.NONE`` a window's points outside the global domain are
        set to 0 after each substep, what a stepwise exchange would
        deliver there. ``overlap`` splits a deep group's first substep
        around its exchange."""
        from ..ops.cuda_mhd import compute_dtype

        dd = self.dd
        prm = self.prm
        comp = compute_dtype(self._dtype)
        store = self._dtype
        radius = dd.radius
        pad_lo = radius.pad_lo()
        inv_ds = (1.0 / prm.dsx, 1.0 / prm.dsy, 1.0 / prm.dsz)
        gsize = dd.size
        s = dd.exchange_every
        nonper = dd.boundary == Boundary.NONE
        origins = [dd.shard_origin(i) for i in range(dd.num_subdomains())]
        state = {q: dd.curr[q] for q in FIELDS}
        state.update({f"w:{q}": [None if w is None else w[q]
                                 for w in self._w] for q in FIELDS})
        w_keys = [f"w:{q}" for q in FIELDS]

        def make_update(start: int):
            def update_fn(blocks, dims, off, k, i):
                sub = (start + k) % 3
                data = {q: FieldData(blocks[q].to(comp), inv_ds, pad_lo,
                                     dims)
                        for q in FIELDS}
                rates = mhd_rates(data, prm, comp)
                alpha = const(RK3_ALPHA[sub], comp)
                beta = const(RK3_BETA[sub], comp)
                dt_ = const(prm.dt, comp)
                if nonper:
                    o = origins[i]
                    gz, gy, gx = global_coords(
                        (o.x + off[0], o.y + off[1], o.z + off[2]), dims,
                        device=blocks[FIELDS[0]].device)
                    inside = ((gx >= 0) & (gx < gsize.x) & (gy >= 0)
                              & (gy < gsize.y) & (gz >= 0) & (gz < gsize.z))
                out = {}
                for q in FIELDS:
                    # w is read pointwise: the window centre of its
                    # base-radius-padded block
                    wv = blocks[f"w:{q}"][pad_lo.z:pad_lo.z + dims.z,
                                          pad_lo.y:pad_lo.y + dims.y,
                                          pad_lo.x:pad_lo.x + dims.x]
                    wq = alpha * wv.to(comp) + dt_ * rates[q]
                    uq = data[q].value + beta * wq
                    if nonper:
                        # the zero-Dirichlet exterior: ring cells beyond
                        # the domain hold 0, as a stepwise exchange
                        # would deliver them
                        uq = torch.where(inside, uq, torch.zeros_like(uq))
                    out[f"w:{q}"] = wq.to(store)
                    out[q] = uq.to(store)
                return out

            return update_fn

        def group(start: int, depth: int) -> None:
            # only the group's first substep reads w from before the
            # group; its window ring needs wire data only where alpha != 0
            # and the window reaches past the interior
            keys = list(FIELDS)
            if RK3_ALPHA[start] != 0.0 and depth > 1:
                keys += w_keys
            temporal_shard_steps(state, radius, dd.mesh_counts, self._method,
                                 make_update(start), depth, alloc_steps=s,
                                 rem=dd.rem, exchange_keys=keys,
                                 overlap=self._overlap and depth > 1,
                                 nonperiodic=nonper, ranks=dd.mesh.peers)

        period = math.lcm(3, s)
        per_period = period // 3
        for _ in range(n // per_period):
            for g in range(period // s):
                group((g * s) % 3, s)
        for _ in range(n % per_period):
            for sub in range(3):
                group(sub, 1)

    def _run_resident(self, n: int) -> None:
        """``n`` iterations on the interior-resident state, three
        launches per shard an iteration: substep 0 with ``w=None``,
        substep 1, substep 2 with ``write_w=False`` — or, with the pair,
        B10/B12 for substeps 0 and 1 and B9/B11 for substep 2. The wrap
        path launches B9/B10 on its one shard; the halo path first
        exchanges the slabs of ALL shards (all 8 fields per slice, radius
        R, or 2R before the pair) and then launches B11/B12 per shard;
        the halo-overlap path runs B13 and B14 per shard and substep
        (``mhd_substep_overlap``), the slabs sent inside B13, all of
        ``run(n)`` in one session of its receive buffers' ordering.
        Every substep writes into the other buffer of a ping-pong pair,
        so no kernel writes what a slab copy still has to read. The
        carried w is the last one written (substep 1's), as in JAX."""
        from ..ops import cuda_mhd as cm
        from ..ops import cuda_mhd_overlap as mo

        own = self.dd.mesh.local_positions
        if self._inner is None:
            cap = self._capacity()
            self._inner = [torch.stack([self.dd.curr[q][i][cap]
                                        for q in FIELDS])
                           if i in own else None
                           for i in range(self.dd.num_subdomains())]
        a = self._inner

        def like(ts):
            return [None if t is None else torch.empty_like(t) for t in ts]

        b = like(a)
        w1 = None if self._pair else like(a)
        w2 = like(a)
        prm, dt = self.prm, self.prm.dt
        counts = self.dd.mesh_counts
        path = self.kernel_path
        halo = path == "halo"
        if path == "halo-overlap" and self._overlap_recv is None:
            self._overlap_recv = mo.MhdOverlapRecv(a, counts,
                                                   self.dd.mesh.peers)
        recv = self._overlap_recv

        def views(ts):
            return None if ts is None else [None if t is None else _views(t)
                                            for t in ts]

        def slabs(rr: int) -> List[Dict[str, Dict[str, torch.Tensor]]]:
            if not halo:
                return [None] * len(a)
            return [None if sl is None else
                    {q: {k: v[j] for k, v in sl.items()}
                     for j, q in enumerate(FIELDS)}
                    for sl in exchange_interior_slabs(
                        a, counts, rz=rr, ry=rr, y_z_extended=True,
                        ranks=self.dd.mesh.peers)]

        def substep(s: int, w_in, w_out) -> None:
            if path == "halo-overlap":
                mo.mhd_substep_overlap(views(a), views(w_in), s, prm, dt,
                                       counts, write_w=w_out is not None,
                                       out_f=views(b), out_w=views(w_out),
                                       recv=recv)
                return
            sls = slabs(cm.R)
            for i in own:
                sl = sls[i]
                wi = None if w_in is None else _views(w_in[i])
                wo = None if w_out is None else _views(w_out[i])
                if halo:
                    cm.mhd_substep_halo_cuda(
                        _views(a[i]), wi, sl, s, prm, dt,
                        write_w=wo is not None, out_f=_views(b[i]),
                        out_w=wo)
                else:
                    cm.mhd_substep_wrap_cuda(
                        _views(a[i]), wi, s, prm, dt,
                        write_w=wo is not None, out_f=_views(b[i]),
                        out_w=wo)

        def pair() -> None:
            if path == "halo-overlap":
                mo.mhd_substep_overlap(views(a), None, 0, prm, dt, counts,
                                       pair=True, out_f=views(b),
                                       out_w=views(w2), recv=recv)
                return
            sls = slabs(2 * cm.R)
            for i in own:
                sl = sls[i]
                out = dict(out_f=_views(b[i]), out_w=_views(w2[i]))
                if halo:
                    cm.mhd_substep01_halo_cuda(_views(a[i]), sl, prm, dt,
                                               **out)
                else:
                    cm.mhd_substep01_wrap_cuda(_views(a[i]), prm, dt, **out)

        with (recv.session() if recv is not None
              else contextlib.nullcontext()):
            for _ in range(n):
                if self._pair:
                    pair()
                    a, b = b, a
                else:
                    substep(0, None, w1)
                    a, b = b, a
                    substep(1, w1, w2)
                    a, b = b, a
                substep(2, w2, None)
                a, b = b, a
        self._inner = a
        self._w = [None if t is None else _views(t) for t in w2]

    def sync_domain(self) -> None:
        """Write the wrap and halo paths' resident interiors back into
        the padded ``dd.curr`` shards (no-op otherwise); the halos stay
        stale until the next exchange. ``dd.set_interior`` calls it
        first; call it before reading or writing ``dd.curr`` directly."""
        if self._inner is not None:
            cap = self._capacity()
            for q, dst in self.dd.curr.items():
                k = FIELDS.index(q)
                for i, t in enumerate(self._inner):
                    if t is not None:
                        dst[i][cap].copy_(t[k])
            self._inner = None

    # -- resilient run loop (resilience/driver.py) -----------------------
    def _live_fields(self) -> Dict[str, List[Optional[torch.Tensor]]]:
        """The live state the sentinel probes and faults hit: views of
        the interior-resident tensors on the kernel paths, else
        ``dd.curr``."""
        if self._inner is None:
            return self.dd.curr
        return {q: [None if t is None else t[k] for t in self._inner]
                for k, q in enumerate(FIELDS)}

    def _w_extras(self):
        """The RK accumulators as checkpoint extras (one list over the
        shards a field), or None before the first iteration."""
        if self._w is None:
            return None
        return {q: [None if w is None else w[q] for w in self._w]
                for q in FIELDS}

    def install_w(self, extras) -> None:
        """Install RK accumulators restored from a checkpoint
        (``_w_extras``' layout; None or empty: none yet)."""
        if not extras:
            self._w = None
            return
        n = self.dd.num_subdomains()
        self._w = [None if extras[FIELDS[0]][i] is None else
                   {q: extras[q][i] for q in FIELDS} for i in range(n)]

    def run_resilient(self, n_steps: int, policy=None,
                      ckpt_dir: Optional[str] = None, faults=None):
        """``n_steps`` RK3 iterations under the checkpoint-rollback
        recovery driver (JAX ``models/astaroth.py:1216``). The RK
        accumulators ride the checkpoint as extras; the interior-resident
        state of the kernel paths is flushed (``sync_domain``) before
        every save and dropped on restore. Returns the
        ``ResilienceReport``."""
        from ..resilience.driver import run_resilient
        from .jacobi import _dcn_request_kwargs

        size = self.dd.size

        def rebuild(cfg):
            new = Astaroth(size.x, size.y, size.z, params=self.prm,
                           mesh_shape=tuple(self.dd.placement.dim()),
                           dtype=self._dtype, devices=self.dd._global,
                           methods=cfg.method, kernel=self._kernel,
                           overlap=self._overlap,
                           exchange_every=cfg.exchange_every,
                           boundary=self.dd.boundary,
                           **_dcn_request_kwargs(self.dd))
            # adopt in place; re-point the interior-write hook at the
            # surviving handle so that sync_domain keeps working
            new.dd._on_interior_write.clear()
            self.__dict__.update(new.__dict__)
            self.dd.on_interior_write(lambda name: self.sync_domain())
            return self.dd, self.step, self.make_segment

        def on_restore(extras):
            # restored state replaces everything the kernel paths cached
            self._inner = None
            self.install_w(extras)

        return run_resilient(
            self.dd, self.step, n_steps, policy=policy,
            ckpt_dir=ckpt_dir, faults=faults, rebuild=rebuild,
            extra_fn=self._w_extras, on_restore=on_restore,
            fields_fn=self._live_fields, pre_checkpoint=self.sync_domain,
            make_segment=self.make_segment, perf_entry="astaroth")

    def block(self) -> None:
        device_sync([t for t in (self._inner if self._inner is not None
                                 else self.dd.curr["lnrho"])
                     if t is not None])

    def _gather(self, shards: Sequence[torch.Tensor]) -> np.ndarray:
        """The global (z,y,x) array on the host from capacity-sized
        unpadded shards (a short shard's dead rows dropped); bfloat16 as
        float32. A collective on a mesh that spans
        processes (``DistributedDomain.gather_blocks``)."""
        blocks = []
        for i, t in enumerate(shards):
            sz = self.dd.shard_size(i)
            blocks.append(None if t is None else t[:sz.z, :sz.y, :sz.x])
        return self.dd.gather_blocks(blocks, self._dtype)

    def field(self, name: str) -> np.ndarray:
        """The global (z,y,x) interior of field ``name`` on the host (a
        copy). bfloat16 fields come out as float32 arrays holding their
        values exactly (numpy has no bfloat16)."""
        if self._inner is None:
            cap = self._capacity()
            return self._gather([None if t is None else t[cap]
                                 for t in self.dd.curr[name]])
        k = FIELDS.index(name)
        return self._gather([None if t is None else t[k]
                             for t in self._inner])

    def accumulator(self, name: str) -> Optional[np.ndarray]:
        """The global (z,y,x) RK3 accumulator ``w`` of field ``name`` on
        the host (a copy; its ring stripped on the temporal path), None
        before the first iteration: the w of the last substep that wrote
        one (the JAX model's ``_w``). bfloat16 as float32, as ``field``."""
        if self._w is None:
            return None
        cap = self._capacity() if self._w_padded else (slice(None),) * 3
        return self._gather([None if w is None else w[name][cap]
                             for w in self._w])

    # -- exchange accounting -------------------------------------------
    def exchange_stats(self) -> dict:
        """Per-iteration exchange accounting of the built path, whole
        mesh (the JAX model's, models/astaroth.py:1071-1119): the wrap
        path has none; the halo path moves, per iteration, one radius-2R
        and one radius-R slab round with the pair and three radius-R
        rounds without (``interior_slab_bytes`` with z-extended y slabs,
        all 8 fields); the xla path exchanges once per substep, the
        temporal path once per group, at depth ``s*R``, the bytes doubled
        for a group that ships w."""
        path = self.kernel_path
        if path == "wrap":
            return {"path": path, "bytes_per_iteration": 0,
                    "rounds_per_iteration": 0.0}
        dd = self.dd
        if path in ("halo", "halo-overlap"):
            from ..ops.cuda_mhd import R as HALO_R

            counts, local = dd.mesh_counts, dd.local_size
            item = torch.empty((), dtype=self._dtype).element_size()

            def rnd(r: int) -> int:
                return interior_slab_bytes(
                    (local.z, local.y, local.x), counts, r, item,
                    y_z_extended=True) * counts.flatten() * len(FIELDS)

            if self._pair:
                return {"path": path,
                        "bytes_per_iteration": rnd(2 * HALO_R) + rnd(HALO_R),
                        "rounds_per_iteration": 2.0}
            return {"path": path, "bytes_per_iteration": 3 * rnd(HALO_R),
                    "rounds_per_iteration": 3.0}
        if self._w_padded:
            # one deep exchange per s substeps; groups that start where
            # alpha != 0 carry the 8 w as well: twice the bytes
            s = dd.exchange_every
            period = math.lcm(3, s)
            starts = [(g * s) % 3 for g in range(period // s)]
            per_ex = float(dd.exchange_bytes_total())
            iters = period // 3
            return {"path": path,
                    "bytes_per_iteration": sum(
                        per_ex * (2.0 if RK3_ALPHA[st] != 0.0 else 1.0)
                        for st in starts) / iters,
                    "rounds_per_iteration": len(starts) / iters}
        return {"path": path,
                "bytes_per_iteration": 3.0 * dd.exchange_bytes_total(),
                "rounds_per_iteration": 3.0}

    def slab_exchange_seconds(self, radius_rows: int, reps: int = 5) -> float:
        """Seconds of one slab round of the halo path (all 8 fields of
        every shard, ``radius_rows`` rows) on zero shards, host clock
        ending in a device synchronize; the state is not touched."""
        dd = self.dd
        c = dd.local_size
        own = set(dd.mesh.local_positions)
        shards = [torch.zeros((len(FIELDS), c.z, c.y, c.x), dtype=self._dtype,
                              device=d) if i in own else None
                  for i, d in enumerate(dd.mesh.devices)]

        def once() -> List:
            return exchange_interior_slabs(shards, dd.mesh_counts,
                                           rz=radius_rows, ry=radius_rows,
                                           y_z_extended=True,
                                           ranks=dd.mesh.peers)

        once()
        device_sync([t for t in shards if t is not None])
        t0 = time.perf_counter()
        for _ in range(reps):
            out = once()
        device_sync([s["yhi"] for s in out if s is not None])
        return (time.perf_counter() - t0) / reps

    def measure_exchange_seconds(self, reps: int = 5) -> float:
        """Exchange seconds per iteration of the built path: 0.0 on the
        wrap path; on the halo path its slab rounds timed standalone
        (``slab_exchange_seconds``); on the xla paths
        ``exchange_stats()["rounds_per_iteration"]`` ``dd.exchange()``
        (three; on the temporal path deep ones, one a group)."""
        from ..ops.cuda_mhd import R as HALO_R

        path = self.kernel_path
        if path == "wrap":
            return 0.0
        if path in ("halo", "halo-overlap"):
            if self._pair:
                return (self.slab_exchange_seconds(2 * HALO_R, reps)
                        + self.slab_exchange_seconds(HALO_R, reps))
            return 3 * self.slab_exchange_seconds(HALO_R, reps)
        self.dd.exchange()
        self.block()
        t0 = time.perf_counter()
        for _ in range(reps):
            self.dd.exchange()
        self.block()
        rounds = self.exchange_stats()["rounds_per_iteration"]
        return rounds * (time.perf_counter() - t0) / reps


# ----------------------------------------------------------------------
# initial-condition fields (reference: astaroth/astaroth.cu:84-200);
# numpy, the JAX package's functions copied as they are
# ----------------------------------------------------------------------
def _hash64(x: np.ndarray) -> np.ndarray:
    """splitmix64-style avalanche (reference: astaroth.cu:84-89)."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def _hash_field(shape_zyx) -> np.ndarray:
    """'bad random numbers from -1 to 1' (reference: astaroth.cu:92-114):
    val = hash(x) ^ hash(y) ^ hash(z) scaled to [-1, 1)."""
    nz, ny, nx = shape_zyx
    hz = _hash64(np.arange(nz))[:, None, None]
    hy = _hash64(np.arange(ny))[None, :, None]
    hx = _hash64(np.arange(nx))[None, None, :]
    h = hx ^ hy ^ hz
    val = h.astype(np.float64) / float(np.iinfo(np.uint64).max)
    return (val - 0.5) * 2.0


def _radial_explosion(size: Dim3, prm: MhdParams
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gaussian shell of radially outward velocity
    (reference: astaroth.cu:136-200): amplitude 1, shell radius 0.8,
    width 0.2, origin (0.01, 32 dsy, 50 dsz); components via the unit
    radial vector."""
    ampl, shell_r, width = 1.0, 0.8, 0.2
    ox, oy, oz = 0.01, 32 * prm.dsy, 50 * prm.dsz
    z, y, x = np.meshgrid(np.arange(size.z), np.arange(size.y),
                          np.arange(size.x), indexing="ij")
    xx = x * prm.dsx - ox
    yy = y * prm.dsy - oy
    zz = z * prm.dsz - oz
    rr = np.sqrt(xx * xx + yy * yy + zz * zz)
    u_rad = ampl * np.exp(-((rr - shell_r) ** 2) / (2.0 * width * width))
    with np.errstate(invalid="ignore", divide="ignore"):
        inv_r = np.where(rr > 0, 1.0 / np.where(rr > 0, rr, 1.0), 0.0)
    return (u_rad * xx * inv_r, u_rad * yy * inv_r, u_rad * zz * inv_r)
