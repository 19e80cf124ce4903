"""Astaroth-parity MHD integrator on one GPU: 8 fields, 6th order, RK3.

PyTorch-port counterpart of ``stencil_tpu/models/astaroth.py``
(reference: astaroth/astaroth.cu, "rough approximation of astaroth
using the stencil library"): 8 scalar fields — lnrho, uu(x,y,z),
aa(x,y,z), entropy — advanced by a Williamson (1980) 3-step low-storage
Runge-Kutta (astaroth/integration.cuh:14-38) with 6th-order central and
cross derivatives (radius 3) and periodic boundaries. The physics
(``mhd_rates``, reference: astaroth/user_kernels.h:383-453) is the JAX
module's expression for expression.

Compute paths (``kernel=``), as in the JAX model on a (1,1,1) mesh:

* ``wrap`` — the single-device fast path. The interiors stay resident
  in contiguous tensors between calls (extracted once, written back on
  ``sync_domain()``/``field()``); one iteration is three launches of the
  fused substep kernel B9 (``mhd_substep_wrap_cuda``): substep 0 with
  ``w=None``, substep 1, substep 2 with ``write_w=False``. With
  ``STENCIL_MHD_PAIR=1`` it is one launch of the pair kernel B10
  (``mhd_substep01_wrap_cuda``) and B9 for substep 2. The carried ``w``
  is the last one written, as in JAX. On the CPU the wrappers run their
  plain twins.
* ``xla`` — per substep: exchange into the radius-3 padded fields, then
  ``FieldData`` + ``mhd_rates`` + the RK update in plain PyTorch, written
  into the interiors in place. The port's reference path; no kernel.
* ``auto`` — ``wrap`` on a CUDA device for float32 when Z and Y are
  multiples of ``mhd_tile`` (8), else ``xla`` (on the CPU too, as the
  JAX model takes ``xla`` off the TPU).

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): ``kernel="halo"``, ``overlap=True``, ``exchange_every >
1``, a mesh of more than one device, ``Boundary.NONE`` and bfloat16.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..distributed import (DeviceLike, DistributedDomain, resolve_device,
                           torch_dtype)
from ..geometry import Dim3, Radius
from ..local_domain import zyx_shape
from ..ops.fd6 import RADIUS, FieldData, const
from ..topology import Boundary
from ..utils.config import load_config, mhd_pair_requested
from ..utils.logging import LOG_INFO
from ..utils.timers import device_sync

FIELDS = ("lnrho", "uux", "uuy", "uuz", "ax", "ay", "az", "ss")

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


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


class Astaroth:
    """MHD integrator on one device."""

    def __init__(self, nx: int, ny: int, nz: int,
                 params: Optional[MhdParams] = None,
                 mesh_shape=None, dtype=torch.float32,
                 overlap: bool = False, kernel: str = "auto",
                 exchange_every: Optional[int] = None,
                 boundary: Optional[Boundary] = None,
                 device: DeviceLike = None) -> None:
        if kernel not in ("auto", "wrap", "halo", "xla"):
            raise ValueError(
                f"kernel must be auto|wrap|halo|xla, got {kernel!r}")
        if mesh_shape is not None and Dim3.of(mesh_shape).flatten() > 1:
            raise NotImplementedError(
                f"mesh {tuple(mesh_shape)}: a mesh of more than one "
                f"device needs the multi-GPU MHD slice (ROADMAP A8c)")
        if kernel == "halo":
            raise NotImplementedError(
                "kernel='halo' (kernels B11/B12) comes with the multi-GPU "
                "MHD slice (ROADMAP A8c)")
        if overlap:
            raise NotImplementedError(
                "overlap=True (kernels B13/B14) comes with the multi-GPU "
                "MHD slice (ROADMAP A8c)")
        if exchange_every is not None and int(exchange_every) > 1:
            raise NotImplementedError(
                "exchange_every > 1 (temporal blocking) comes with "
                "ROADMAP A7 and the multi-GPU MHD slice (A8c)")
        if boundary is not None and boundary != Boundary.PERIODIC:
            raise NotImplementedError(
                f"boundary {boundary}: only periodic boundaries are in "
                f"this slice (Boundary.NONE: ROADMAP A8d)")
        self._dtype = torch_dtype(dtype)
        if self._dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(
                f"dtype {self._dtype}: bfloat16 storage (f32 compute) is "
                f"ROADMAP A8b; this slice runs float32 and float64")
        self.prm = params or MhdParams()
        # one device: the MHD mesh paths are a later slice (ROADMAP A8c)
        self.dd = DistributedDomain(nx, ny, nz, device=resolve_device(device))
        self.dd.set_radius(Radius.constant(RADIUS))
        for q in FIELDS:
            self.dd.add_data(q, self._dtype)
        self.dd.realize()
        self._kernel = kernel
        # RK3 accumulators, interior-shaped (no halos); None until the
        # first iteration
        self._w: Optional[Dict[str, torch.Tensor]] = None
        # interior-resident state of the wrap path (see sync_domain)
        self._inner: Optional[Dict[str, torch.Tensor]] = None
        self._build_step()

    # -- initial conditions (reference: astaroth/astaroth.cu:509-528) --
    def init(self) -> None:
        """hash-random all fields in [-1, 1); lnrho constant 0.5;
        radial-explosion shell velocity."""
        self._inner = None
        size = self.dd.size
        shape = zyx_shape(size)
        npdt = _numpy_dtype(self._dtype)
        # the reference's hash init has no per-field seed, so all fields
        # get the identical array (astaroth.cu:509-528)
        noise = _hash_field(shape).astype(npdt)
        for q in ("ax", "ay", "az", "ss"):
            self.dd.set_interior(q, noise)
        self.dd.set_interior("lnrho", np.full(shape, 0.5, dtype=npdt))
        ux, uy, uz = _radial_explosion(size, self.prm)
        self.dd.set_interior("uux", ux.astype(npdt))
        self.dd.set_interior("uuy", uy.astype(npdt))
        self.dd.set_interior("uuz", uz.astype(npdt))
        self._w = None

    def load_state(self, fields: Dict[str, np.ndarray],
                   w: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Start from a given state: ``fields[q]`` the global (z,y,x)
        interiors and ``w`` the RK accumulators (or None), as numpy —
        for instance a JAX model's ``field(q)`` and ``_w`` (see
        ``convert.astaroth_state_from_jax``). Carried bit for bit."""
        from ..convert import astaroth_state_from_jax

        padded, wt = astaroth_state_from_jax(fields, w, device=self.dd.device,
                                             dtype=self._dtype)
        self._inner = None
        for q in FIELDS:
            self.dd.curr[q][0].copy_(padded[q])
        self._w = wt

    # -- path selection -------------------------------------------------
    def _build_step(self) -> None:
        from ..ops.cuda_mhd import mhd_tile

        local = self.dd.size
        tile = mhd_tile(self._dtype)
        wrap_ok = local.z % tile == 0 and local.y % tile == 0
        on_gpu = self.dd.device.type == "cuda"
        kernel = self._kernel
        if kernel == "auto":
            kernel = ("wrap" if on_gpu and wrap_ok
                      and self._dtype == torch.float32 else "xla")
            LOG_INFO(f"astaroth kernel path: {kernel}")
        if kernel == "wrap":
            if not wrap_ok:
                raise ValueError(
                    "kernel='wrap' needs a (1,1,1) mesh, even grid, z/y "
                    f"multiples of the dtype sublane tile ({tile}), "
                    "overlap off")
            if on_gpu and self._dtype != torch.float32:
                raise TypeError(f"kernel='wrap' runs CUDA kernels that take "
                                f"float32 only, got {self._dtype}; use "
                                f"kernel='xla'")
            self._pair = mhd_pair_requested()
            if self._pair:
                LOG_INFO("astaroth wrap path: fused substep-0+1 kernel")
        self.kernel_path = kernel

    # -- stepping -------------------------------------------------------
    def _ensure_w(self) -> None:
        if self._w is None:
            shape = zyx_shape(self.dd.size)
            self._w = {q: torch.zeros(shape, dtype=self._dtype,
                                      device=self.dd.device)
                       for q in FIELDS}

    def step(self) -> None:
        """One full RK3 iteration (3 substeps)."""
        self.run(1)

    def run(self, iters: int) -> None:
        self._ensure_w()
        for _ in range(int(iters)):
            if self.kernel_path == "wrap":
                self._iter_wrap()
            else:
                for s in range(3):
                    self._substep_xla(s)

    def _substep_xla(self, s: int) -> None:
        """One substep on the padded fields: exchange, rates, update
        ``wq = alpha*w + dt*rates; u = value + beta*wq`` (the JAX
        model's ``substep_fused``), the interiors written in place."""
        from ..ops.cuda_mhd import compute_dtype

        dd = self.dd
        prm = self.prm
        comp = compute_dtype(self._dtype)
        pad_lo = dd.radius.pad_lo()
        inv_ds = (1.0 / prm.dsx, 1.0 / prm.dsy, 1.0 / prm.dsz)
        dd.exchange()
        data = {q: FieldData(dd.curr[q][0].to(comp), inv_ds, pad_lo, dd.size)
                for q in FIELDS}
        rates = mhd_rates(data, prm, comp)
        alpha = const(RK3_ALPHA[s], comp)
        beta = const(RK3_BETA[s], comp)
        dt_ = const(prm.dt, comp)
        new_w = {}
        for q in FIELDS:
            wq = alpha * self._w[q].to(comp) + dt_ * rates[q]
            uq = data[q].value + beta * wq
            new_w[q] = wq.to(self._dtype)
            dd.interior(q).copy_(uq)
        self._w = new_w

    def _iter_wrap(self) -> None:
        """One iteration on the resident interiors. Dead-w elision as in
        JAX: substep 0 never reads w (alpha_0 == 0, ``w=None``) and
        nothing reads substep 2's w (``write_w=False``); the carried w
        is substep 1's."""
        from ..ops.cuda_mhd import (mhd_substep01_wrap_cuda,
                                    mhd_substep_wrap_cuda)

        if self._inner is None:
            self._inner = {q: self.dd.interior(q).clone(
                memory_format=torch.contiguous_format) for q in FIELDS}
        f = self._inner
        prm, dt = self.prm, self.prm.dt
        if self._pair:
            f, wk = mhd_substep01_wrap_cuda(f, prm, dt)
        else:
            f, wk = mhd_substep_wrap_cuda(f, None, 0, prm, dt)
            f, wk = mhd_substep_wrap_cuda(f, wk, 1, prm, dt)
        f, _ = mhd_substep_wrap_cuda(f, wk, 2, prm, dt, write_w=False)
        self._inner = f
        self._w = wk

    def sync_domain(self) -> None:
        """Write the wrap path's resident interiors back into the padded
        ``dd.curr`` fields (no-op otherwise); the halos stay stale until
        the next exchange. Call it before reading or writing
        ``dd.curr`` directly."""
        if self._inner is not None:
            for q in FIELDS:
                self.dd.interior(q).copy_(self._inner[q])
            self._inner = None

    def block(self) -> None:
        inner = self._inner
        device_sync(inner["lnrho"] if inner is not None
                    else self.dd.curr["lnrho"])

    def field(self, name: str) -> np.ndarray:
        """The global (z,y,x) interior of field ``name`` on the host (a
        copy)."""
        t = (self._inner[name] if self._inner is not None
             else self.dd.interior(name))
        return t.to("cpu", copy=True).numpy()

    # -- exchange accounting -------------------------------------------
    def exchange_stats(self) -> dict:
        """Per-iteration exchange accounting of the built path: the wrap
        path has no exchange; the xla path exchanges once per substep,
        and on one device that moves 0 bytes between devices."""
        if self.kernel_path == "wrap":
            return {"path": "wrap", "bytes_per_iteration": 0,
                    "rounds_per_iteration": 0.0}
        return {"path": self.kernel_path,
                "bytes_per_iteration": 3.0 * self.dd.exchange_bytes_total(),
                "rounds_per_iteration": 3.0}

    def measure_exchange_seconds(self, reps: int = 5) -> float:
        """Exchange seconds per iteration (three ``dd.exchange()`` on the
        xla path, timed standalone); 0.0 on the wrap path."""
        if self.kernel_path == "wrap":
            return 0.0
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
