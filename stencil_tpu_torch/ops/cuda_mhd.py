"""Hand-written CUDA kernels for the fused MHD RK3 substeps, with plain
twins.

PyTorch-port counterpart of ``stencil_tpu/ops/pallas_mhd.py``. Each TPU
kernel becomes a CUDA kernel for Hopper (``csrc/mhd.cu``) behind a
wrapper, beside a plain PyTorch twin that computes the same function
(``FieldData`` + ``mhd_rates`` + the Williamson update) in the same
order of operations:

===  ======================================  ===========================  ============================
#    TPU kernel (pallas_mhd.py)              wrapper                      plain twin
===  ======================================  ===========================  ============================
B9   :186 ``mhd_substep_wrap_pallas``        ``mhd_substep_wrap_cuda``    ``mhd_substep_wrap_plain``
B10  :347 ``mhd_substep01_wrap_pallas``      ``mhd_substep01_wrap_cuda``  ``mhd_substep01_wrap_plain``
===  ======================================  ===========================  ============================

Layout (as in JAX): 8 unpadded (Z, Y, X) fields, periodic in all three
axes inside the kernel; Z and Y multiples of ``mhd_tile`` (8); ``w=None``
only where ``alpha_s == 0``. A wrapper dispatches on the tensors'
device: CPU tensors go to the plain twin (any float dtype; bfloat16
stored, float32 computed, see ``compute_dtype``); CUDA tensors launch
the kernel (float32 only, else ``TypeError``) or raise — never the twin.
Each launch adds one to the wrapper's entry in ``LAUNCHES``.

The kernels evaluate ``exp`` with CUDA's ``expf`` and the twins with
PyTorch's; everything else is formed in the twins' order, built
``-fmad=false``. Kernel and twin agree to a few float32 ulps of each
field's largest value (the tests and ``chip_smoke.py`` hold them to
``64 * eps(float32) * max|twin|`` per field).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry import Dim3
from .cuda_stencil import sublane_tile
from .fd6 import FieldData, const

R = 3          # stencil radius (6th order)

Fields = Dict[str, torch.Tensor]

#: launches per wrapper since the last ``reset_launch_counts``; only a
#: kernel launch counts, never a call that went to the plain twin
LAUNCHES = {"mhd_substep_wrap": 0, "mhd_substep01_wrap": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def compute_dtype(store_dtype: torch.dtype) -> torch.dtype:
    """The dtype the right-hand sides are evaluated in for a storage
    dtype: bfloat16 fields are stored half-width but evaluated in
    float32 (bf16's 8 mantissa bits are too few for the 6th-order
    coefficient sums); every other dtype computes in itself."""
    return torch.float32 if store_dtype == torch.bfloat16 else store_dtype


def mhd_tile(dtype: torch.dtype) -> int:
    """Z and Y granularity of the MHD wrap kernels: the TPU's sublane
    tile for ``dtype`` (8 for float32/float64, 16 for bfloat16). The GPU
    kernels need no such tile; the port keeps the rule so that a grid
    takes the same path in both packages."""
    return sublane_tile(dtype)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------
def _periodic_window(t: torch.Tensor, r: int) -> torch.Tensor:
    """(Z + 2r, Y + 2r, X) window of a periodic (Z, Y, X) field: z and y
    extended by ``r`` wrapped rows on each side, x left whole (the
    FieldData ``x_wrap`` mode rolls it)."""
    t = torch.cat([t[-r:], t, t[:r]], 0)
    return torch.cat([t[:, -r:], t, t[:, :r]], 1)


def _inv_ds(prm) -> Tuple[float, float, float]:
    return (1.0 / prm.dsx, 1.0 / prm.dsy, 1.0 / prm.dsz)


def mhd_substep_wrap_plain(fields: Fields, w: Optional[Fields], s: int, prm,
                           dt_phys: float, write_w: bool = True
                           ) -> Tuple[Fields, Optional[Fields]]:
    """B9's twin: one RK3 substep ``s`` on unpadded periodic fields, in
    the order of ``mhd_substep_wrap_pallas`` (pallas_mhd.py:247-261):
    ``wq = dt*rates``, then ``wq = alpha*w + wq`` only when ``w`` is
    given; ``f = value + beta*wq``. Returns (new_fields, new_w or
    None)."""
    from ..models.astaroth import FIELDS, RK3_ALPHA, RK3_BETA, mhd_rates

    Z, Y, X = fields[FIELDS[0]].shape
    dtype = fields[FIELDS[0]].dtype
    comp = compute_dtype(dtype)
    alpha = float(RK3_ALPHA[s])
    beta = float(RK3_BETA[s])
    if w is None and alpha != 0.0:
        raise ValueError("w=None is only valid when alpha_s == 0")
    pad_lo = Dim3(0, R, R)
    interior = Dim3(X, Y, Z)
    data = {q: FieldData(_periodic_window(fields[q], R).to(comp),
                         _inv_ds(prm), pad_lo, interior, x_wrap=True)
            for q in FIELDS}
    rates = mhd_rates(data, prm, comp)
    new_f = {}
    new_w = {} if write_w else None
    for q in FIELDS:
        wq = const(float(dt_phys), comp) * rates[q]
        if w is not None:
            wq = const(alpha, comp) * w[q].to(comp) + wq
        if write_w:
            new_w[q] = wq.to(dtype)
        new_f[q] = (data[q].value + const(beta, comp) * wq).to(dtype)
    return new_f, new_w


def mhd_pair_update(wins: Fields, prm, dtype: torch.dtype, dt_phys: float,
                    bz: int, by: int) -> Tuple[Fields, Fields]:
    """The fused RK substep-0+1 update on radius-2R windows
    (pallas_mhd.py:292-344): ``wins[q]`` is the (bz + 4R, by + 4R, X)
    window; returns ``({q: f2}, {q: w2})`` as (bz, by, X) blocks.
    alpha_0 == 0 makes the pair independent of the incoming w: rates_0
    on the ring-extended region, (f_1, w_1) formed from it, rates_1 on
    the block — each point's operations in the order of two substeps.
    ``dtype`` is the storage dtype (see ``compute_dtype``)."""
    from ..models.astaroth import FIELDS, RK3_ALPHA, RK3_BETA, mhd_rates

    assert float(RK3_ALPHA[0]) == 0.0, "pair fusion needs alpha_0 == 0"
    R2 = 2 * R
    comp = compute_dtype(dtype)
    dt_ = const(float(dt_phys), comp)
    beta0 = const(float(RK3_BETA[0]), comp)
    alpha1 = const(float(RK3_ALPHA[1]), comp)
    beta1 = const(float(RK3_BETA[1]), comp)
    inv_ds = _inv_ds(prm)
    pad = Dim3(0, R, R)
    int0 = Dim3(wins[FIELDS[0]].shape[2], by + R2, bz + R2)
    int1 = Dim3(wins[FIELDS[0]].shape[2], by, bz)
    data0 = {q: FieldData(wins[q].to(comp), inv_ds, pad, int0, x_wrap=True)
             for q in FIELDS}
    rates0 = mhd_rates(data0, prm, comp)
    data1 = {}
    w1 = {}
    for q in FIELDS:
        w1[q] = dt_ * rates0[q]                    # alpha_0 == 0
        f1 = data0[q].value + beta0 * w1[q]
        data1[q] = FieldData(f1, inv_ds, pad, int1, x_wrap=True)
    rates1 = mhd_rates(data1, prm, comp)
    out_f = {}
    out_w = {}
    for q in FIELDS:
        w1c = w1[q][R:R + bz, R:R + by]
        wq = alpha1 * w1c + dt_ * rates1[q]
        out_w[q] = wq.to(dtype)
        out_f[q] = (data1[q].value + beta1 * wq).to(dtype)
    return out_f, out_w


def mhd_substep01_wrap_plain(fields: Fields, prm, dt_phys: float
                             ) -> Tuple[Fields, Fields]:
    """B10's twin: RK substeps 0 and 1 on unpadded periodic fields — the
    pair update on the whole field's radius-2R periodic window. Equals
    ``mhd_substep_wrap_plain(f, None, 0)`` followed by
    ``mhd_substep_wrap_plain(f1, w1, 1)``."""
    from ..models.astaroth import FIELDS

    Z, Y, X = fields[FIELDS[0]].shape
    wins = {q: _periodic_window(t, 2 * R) for q, t in fields.items()}
    return mhd_pair_update(wins, prm, fields[FIELDS[0]].dtype, dt_phys, Z, Y)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_LIB = "mhd"
_I = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {
    # (fields[8], w[8] or NULL, out_f[8], out_w[8] or NULL, Z, Y, X,
    #  consts, n_consts, stream)
    "mhd_substep_wrap_launch": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _P],
    # (fields[8], out_f[8], out_w[8], Z, Y, X, consts, n_consts, stream)
    "mhd_substep01_wrap_launch": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
}


def kernel_consts(prm, dt_phys: float, s: int = 0) -> np.ndarray:
    """The constants the kernels read, in ``struct Consts`` order
    (csrc/mhd.cu), each computed as ``mhd_rates``/``fd6`` compute it in
    Python and rounded once to float32 — the twins' ``const(v,
    float32)``. ``s`` picks B9's substep (alpha, beta); B10 reads the
    substep-0 and -1 coefficients."""
    from ..models.astaroth import RK3_ALPHA, RK3_BETA

    ix, iy, iz = _inv_ds(prm)
    vals = [
        ix, iy, iz,                                   # der1
        ix * ix, iy * iy, iz * iz,                    # der2
        ix * iy, ix * iz, iy * iz,                    # der_cross
        1.0 / 3.0, 2.0 / 3.0, 0.5, 1.0 / prm.mu0, prm.eta,
        prm.cs2_sound, prm.gamma / prm.cp_sound, prm.gamma - 1.0,
        prm.lnrho0, 1.0 / prm.cp_sound, prm.nu_visc, 2.0, prm.zeta,
        prm.lnT0, prm.eta * prm.mu0, 2.0 * prm.nu_visc, prm.gamma, 1.0,
        0.001, prm.cp_sound,
        float(dt_phys), RK3_ALPHA[s], RK3_BETA[s],
        RK3_BETA[0], RK3_ALPHA[1], RK3_BETA[1],
    ]
    return np.asarray(vals, dtype=np.float64).astype(np.float32)


def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _check_fields(fields: Fields, w: Optional[Fields], what: str):
    from ..models.astaroth import FIELDS

    if set(fields) != set(FIELDS):
        raise ValueError(f"{what}: fields must be exactly {FIELDS}")
    f0 = fields[FIELDS[0]]
    if f0.dim() != 3:
        raise ValueError(f"{what}: expected (Z, Y, X) fields, got shape "
                         f"{tuple(f0.shape)}")
    if not f0.is_floating_point():
        raise TypeError(f"{what}: fields must be floating point, got "
                        f"{f0.dtype}")
    Z, Y, X = f0.shape
    tile = mhd_tile(f0.dtype)
    if Z % tile or Y % tile:
        raise ValueError(f"{what}: Z and Y must be multiples of {tile}, "
                         f"got (Z, Y, X) = {(Z, Y, X)}")
    for name, group in (("fields", fields), ("w", w or {})):
        for q, t in group.items():
            if (t.shape != f0.shape or t.dtype != f0.dtype
                    or t.device != f0.device):
                raise ValueError(f"{what}: {name}[{q!r}] is {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}, expected "
                                 f"{f0.dtype} {tuple(f0.shape)} on "
                                 f"{f0.device}")
    if w is not None and set(w) != set(FIELDS):
        raise ValueError(f"{what}: w must hold exactly {FIELDS}")
    return f0


def _check_cuda(f0: torch.Tensor, tensors, what: str) -> None:
    if not f0.is_cuda:
        raise ValueError(f"{what}: tensors on {f0.device}, expected cuda "
                         f"(or cpu for the plain twin)")
    if f0.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32, got "
                        f"{f0.dtype}")
    if f0.numel() >= 2 ** 31:
        raise ValueError(f"{what}: fields of 2^31 points or more are not "
                         f"supported (32-bit offsets)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")


def _launch(fn_name: str, device: torch.device, *args) -> None:
    from . import _build

    _build.launch(_LIB, fn_name, _SIGNATURES[fn_name], device, *args)


def mhd_substep_wrap_cuda(fields: Fields, w: Optional[Fields], s: int, prm,
                          dt_phys: float, write_w: bool = True
                          ) -> Tuple[Fields, Optional[Fields]]:
    """B9: one fused RK3 substep ``s`` on 8 unpadded periodic (Z, Y, X)
    fields. Returns (new_fields, new_w); ``new_w`` is None when
    ``write_w=False``. ``w=None`` (only for ``alpha_s == 0``) skips the
    w read; ``write_w=False`` skips the w write — the dead-w elision of
    ``mhd_substep_wrap_pallas``."""
    from ..models.astaroth import FIELDS, RK3_ALPHA

    what = "mhd_substep_wrap_cuda"
    f0 = _check_fields(fields, w, what)
    if w is None and float(RK3_ALPHA[s]) != 0.0:
        raise ValueError(f"{what}: w=None is only valid when alpha_s == 0 "
                         f"(substep {s} has alpha {RK3_ALPHA[s]})")
    if f0.device.type == "cpu":
        return mhd_substep_wrap_plain(fields, w, s, prm, dt_phys,
                                      write_w=write_w)
    ins = [fields[q] for q in FIELDS]
    w_in = [w[q] for q in FIELDS] if w is not None else []
    _check_cuda(f0, ins + w_in, what)
    Z, Y, X = f0.shape
    out_f = {q: torch.empty_like(f0) for q in FIELDS}
    out_w = {q: torch.empty_like(f0) for q in FIELDS} if write_w else None
    consts = kernel_consts(prm, dt_phys, s)
    # the pointer arrays are locals: they must outlive the call
    p_in, p_f = _ptrs(ins), _ptrs([out_f[q] for q in FIELDS])
    p_w = _ptrs(w_in) if w_in else None
    p_wo = _ptrs([out_w[q] for q in FIELDS]) if write_w else None
    _launch("mhd_substep_wrap_launch", f0.device, p_in, p_w, p_f, p_wo,
            Z, Y, X, consts.ctypes.data, consts.size)
    LAUNCHES["mhd_substep_wrap"] += 1
    return out_f, out_w


def mhd_substep01_wrap_cuda(fields: Fields, prm, dt_phys: float
                            ) -> Tuple[Fields, Fields]:
    """B10: RK3 substeps 0 and 1 fused into one launch on 8 unpadded
    periodic (Z, Y, X) fields (alpha_0 == 0, so no w is read). Returns
    (f_2, w_2); equals B9(s=0, ``w=None``) followed by B9(s=1) to the
    kernels' tolerance."""
    from ..models.astaroth import FIELDS

    what = "mhd_substep01_wrap_cuda"
    f0 = _check_fields(fields, None, what)
    if f0.device.type == "cpu":
        return mhd_substep01_wrap_plain(fields, prm, dt_phys)
    ins = [fields[q] for q in FIELDS]
    _check_cuda(f0, ins, what)
    Z, Y, X = f0.shape
    out_f = {q: torch.empty_like(f0) for q in FIELDS}
    out_w = {q: torch.empty_like(f0) for q in FIELDS}
    consts = kernel_consts(prm, dt_phys)
    p_in, p_f = _ptrs(ins), _ptrs([out_f[q] for q in FIELDS])
    p_w = _ptrs([out_w[q] for q in FIELDS])
    _launch("mhd_substep01_wrap_launch", f0.device, p_in, p_f, p_w,
            Z, Y, X, consts.ctypes.data, consts.size)
    LAUNCHES["mhd_substep01_wrap"] += 1
    return out_f, out_w
