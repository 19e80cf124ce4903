"""Hand-written CUDA kernels for the fused MHD RK3 substeps, with plain
twins.

PyTorch-port counterpart of ``stencil_tpu/ops/pallas_mhd.py``. Each TPU
kernel becomes a CUDA kernel for Hopper (``csrc/mhd.cu``) behind a
wrapper, beside a plain PyTorch twin that computes the same function
(``FieldData`` + ``mhd_rates`` + the Williamson update) in the same
order of operations:

===  ======================================  ===========================  ============================
#    TPU kernel                              wrapper                      plain twin
===  ======================================  ===========================  ============================
B9   pallas_mhd.py:186                       ``mhd_substep_wrap_cuda``    ``mhd_substep_wrap_plain``
     ``mhd_substep_wrap_pallas``
B10  pallas_mhd.py:347                       ``mhd_substep01_wrap_cuda``  ``mhd_substep01_wrap_plain``
     ``mhd_substep01_wrap_pallas``
B11  pallas_halo.py:852                      ``mhd_substep_halo_cuda``    ``mhd_substep_halo_plain``
     ``mhd_substep_halo_pallas``
B12  pallas_halo.py:969                      ``mhd_substep01_halo_cuda``  ``mhd_substep01_halo_plain``
     ``mhd_substep01_halo_pallas``
===  ======================================  ===========================  ============================

Layout (as in JAX): 8 unpadded (Z, Y, X) fields; Z and Y multiples of
``mhd_tile`` (8; 16 for bfloat16); ``w=None`` only where ``alpha_s == 0``. B9/B10 are
periodic in all three axes inside the kernel. B11/B12 take the shard of
a z/y-sharded mesh and, per field, its four halo slabs (``slabs[q] =
{"zlo", "zhi", "ylo", "yhi"}``, see ``halo_window``); x wraps inside the
kernel. B9 and B11 launch one kernel (``csrc/mhd_ring.cuh``, a
z-streaming ring of planes in shared memory, which also computes B13's
interior), each block walking ``ring_zrun`` z planes; they differ only
in where the kernel reads a margin row (the field's own wrapped rows,
or the shard's slabs), so on a (1,1,1) mesh they agree bitwise. The
substep pairs (substeps 0 and 1) are the same kernel launched in turn:
B10 is B9 s=0 then B9 s=1; B12 is B11 s=0 over the shard, substep 0
over the R rows around it that substep 1 reads (``margin_plan``: from
the shard's slabs of 2R rows, written as R-row slabs), then B11 s=1 —
each equal to its one-substep chain bit for bit. A wrapper dispatches
on the tensors' device: CPU tensors go to the plain twin (any float
dtype; bfloat16 stored, float32 computed, see ``compute_dtype``); CUDA
tensors launch the kernel (float32 or bfloat16, else ``TypeError``) or
raise — never the twin. Each wrapper call adds one to the wrapper's
entry in ``LAUNCHES`` (a B10 call is two kernel launches and a B12 call
three, each counted once).

bfloat16 fields (``mhd_tile`` 16): the kernels widen every input to
float32, compute exactly what the float32 kernel computes on the widened
values, and round each output once to bfloat16 — the twins' order too.
The pairs' intermediates f_1, w_1 (and B12's margin) stay float32, as
in every JAX pair form (``mhd_pair_update``), so a bfloat16 pair does
not equal two bfloat16 substeps, which round f_1 and w_1 in between: the
pair-equals-chain rule holds bit for bit in float32 only, and in
bfloat16 for the kernels' chain with float32 scratch, which is what they
launch.

The kernels evaluate ``exp`` with CUDA's ``expf`` and the twins with
PyTorch's; everything else is formed in the twins' order, built
``-fmad=false``. Kernel and twin agree to a few float32 ulps of each
field's largest value (the tests and ``chip_smoke.py`` hold them to
``64 * eps(float32) * max|twin|`` per field).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import Dim3
from .cuda_stencil import sm_count, sublane_tile
from .fd6 import FieldData, const

R = 3          # stencil radius (6th order)

Fields = Dict[str, torch.Tensor]

#: launches per wrapper since the last ``reset_launch_counts``; only a
#: kernel launch counts, never a call that went to the plain twin
LAUNCHES = {"mhd_substep_wrap": 0, "mhd_substep01_wrap": 0,
            "mhd_substep_halo": 0, "mhd_substep01_halo": 0}

SLAB_NAMES = ("zlo", "zhi", "ylo", "yhi")


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


def _substep_on_windows(wins: Fields, w: Optional[Fields], s: int, prm,
                        dt_phys: float, write_w: bool
                        ) -> Tuple[Fields, Optional[Fields]]:
    """One RK3 substep ``s`` on radius-R windows ``wins[q]`` of shape
    (Z + 2R, Y + 2R, X), x whole (FieldData's ``x_wrap`` rolls it), in
    the order of the JAX substep kernels (pallas_mhd.py:247-261,
    pallas_halo.py:929-938): ``wq = dt*rates``, then ``wq = alpha*w +
    wq`` only when ``w`` is given; ``f = value + beta*wq``. Returns
    (new_fields, new_w or None) of shape (Z, Y, X)."""
    from ..models.astaroth import FIELDS, RK3_ALPHA, RK3_BETA, mhd_rates

    Zw, Yw, X = wins[FIELDS[0]].shape
    dtype = wins[FIELDS[0]].dtype
    comp = compute_dtype(dtype)
    alpha = float(RK3_ALPHA[s])
    beta = float(RK3_BETA[s])
    if w is None and alpha != 0.0:
        raise ValueError("w=None is only valid when alpha_s == 0")
    pad_lo = Dim3(0, R, R)
    interior = Dim3(X, Yw - 2 * R, Zw - 2 * R)
    data = {q: FieldData(wins[q].to(comp), _inv_ds(prm), pad_lo, interior,
                         x_wrap=True)
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


def mhd_substep_wrap_plain(fields: Fields, w: Optional[Fields], s: int, prm,
                           dt_phys: float, write_w: bool = True
                           ) -> Tuple[Fields, Optional[Fields]]:
    """B9's twin: one RK3 substep ``s`` on unpadded periodic fields, in
    the order of ``mhd_substep_wrap_pallas`` (pallas_mhd.py:247-261).
    Returns (new_fields, new_w or None)."""
    wins = {q: _periodic_window(t, R) for q, t in fields.items()}
    return _substep_on_windows(wins, w, s, prm, dt_phys, write_w)


def halo_window(t: torch.Tensor, slabs: Dict[str, torch.Tensor],
                rr: int) -> torch.Tensor:
    """The (Z + 2rr, Y + 2rr, X) window of a (Z, Y, X) shard and its
    slabs, the semantics of ``_mhd_window_plan``'s ``select_window``
    (pallas_halo.py:774-847), with the z/y index i of the window holding
    shard row i - rr:

    * z in [0, Z) and y in [0, Y): the shard;
    * z outside [0, Z), y in [0, Y): the z slabs, ``zlo[z + rz]`` below
      (its last rows) and ``zhi[z - Z]`` above (its first rows);
    * y outside [0, Y), at every z of the window: the z-extended y
      slabs, ``ylo[z + rz, y + ry]`` and ``yhi[z + rz, y - Y]`` — so the
      yz corners come from the y slabs (``sel3``, :796-806).

    The slabs are those of ``exchange_interior_slabs`` with
    ``y_z_extended=True``: ``zlo``/``zhi`` (rz, Y, X) and ``ylo``/``yhi``
    (Z + 2rz, ry, X), holding at least ``rr`` valid rows — JAX's layout
    (rz = block_z, ry = 8, zero filler) or exact rows (rz = ry = rr)."""
    Z = t.shape[0]
    zlo, zhi, ylo, yhi = (slabs[k] for k in SLAB_NAMES)
    rz = zlo.shape[0]
    ry = ylo.shape[1]
    mid = torch.cat([zlo[rz - rr:], t, zhi[:rr]], dim=0)
    zs = slice(rz - rr, rz + Z + rr)
    return torch.cat([ylo[zs, ry - rr:], mid, yhi[zs, :rr]], dim=1)


def mhd_substep_halo_plain(fields: Fields, w: Optional[Fields],
                           slabs: Dict[str, Dict[str, torch.Tensor]], s: int,
                           prm, dt_phys: float, write_w: bool = True
                           ) -> Tuple[Fields, Optional[Fields]]:
    """B11's twin: one RK3 substep ``s`` on (Z, Y, X) shards with their
    slabs (``halo_window`` at radius R), then exactly B9's twin's
    arithmetic (pallas_halo.py:929-938). Returns (new_fields, new_w or
    None)."""
    wins = {q: halo_window(t, slabs[q], R) for q, t in fields.items()}
    return _substep_on_windows(wins, w, s, prm, dt_phys, write_w)


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
    """B10's twin: RK3 substeps 0 and 1 on unpadded periodic fields — the
    pair update on the whole field's radius-2R periodic window. Equals
    ``mhd_substep_wrap_plain(f, None, 0)`` followed by
    ``mhd_substep_wrap_plain(f1, w1, 1)``."""
    from ..models.astaroth import FIELDS

    Z, Y, X = fields[FIELDS[0]].shape
    wins = {q: _periodic_window(t, 2 * R) for q, t in fields.items()}
    return mhd_pair_update(wins, prm, fields[FIELDS[0]].dtype, dt_phys, Z, Y)


def mhd_substep01_halo_plain(fields: Fields,
                             slabs: Dict[str, Dict[str, torch.Tensor]], prm,
                             dt_phys: float) -> Tuple[Fields, Fields]:
    """B12's twin: RK3 substeps 0 and 1 on (Z, Y, X) shards — the pair
    update on each field's radius-2R ``halo_window`` (the slabs must hold
    2R valid rows). Equals ``mhd_substep_halo_plain(f, None, slabs, 0)``
    then ``mhd_substep_halo_plain(f1, w1, slabs1, 1)`` where ``slabs1``
    are the slabs of the neighbours' substep-0 results."""
    from ..models.astaroth import FIELDS

    Z, Y, X = fields[FIELDS[0]].shape
    wins = {q: halo_window(t, slabs[q], 2 * R) for q, t in fields.items()}
    return mhd_pair_update(wins, prm, fields[FIELDS[0]].dtype, dt_phys, Z, Y)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_LIB = "mhd"
_I = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {
    # (fields[8], w[8] or NULL, out_f[8], out_w[8] or NULL, Z, Y, X,
    #  zrun, consts, n_consts, is_bf16, stream)
    "mhd_substep_wrap_launch": [_P] * 4 + [_I] * 4 + [_P, _I, _I, _P],
    # (fields[8], f1[8], w1[8], out_f[8], out_w[8], Z, Y, X, zrun, consts,
    #  n_consts, is_bf16, stream)
    "mhd_substep01_wrap_launch": [_P] * 5 + [_I] * 4 + [_P, _I, _I, _P],
    # (fields[8], w[8] or NULL, slabs[32], out_f[8], out_w[8] or NULL,
    #  Z, Y, X, rz, ry, zrun, consts, n_consts, is_bf16, stream)
    "mhd_substep_halo_launch": [_P] * 5 + [_I] * 6 + [_P, _I, _I, _P],
    # (fields[8], slabs[32], f1[8], w1[8], margin[8], slabs1[32],
    #  out_f[8], out_w[8], Z, Y, X, rz, ry, zrun, plan, n_plan, n_margin,
    #  consts, n_consts, is_bf16, stream)
    "mhd_substep01_halo_launch": ([_P] * 8 + [_I] * 6 + [_P, _I, _I, _P, _I,
                                                         _I, _P]),
}

#: the storage dtypes the kernels take (``is_bf16`` of the launchers):
#: JAX's ``_fast_dtype_ok`` (float32, and bfloat16 computed in float32)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def is_bf16(t: torch.Tensor) -> int:
    """The launchers' ``is_bf16`` argument for fields like ``t``."""
    return int(t.dtype == torch.bfloat16)


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
    if f0.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: the CUDA kernel takes float32 or "
                        f"bfloat16, got {f0.dtype}")
    if f0.numel() >= 2 ** 31:
        raise ValueError(f"{what}: fields of 2^31 points or more are not "
                         f"supported (32-bit offsets)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")


def _launch(fn_name: str, device: torch.device, *args) -> None:
    from . import _build

    _build.launch(_LIB, fn_name, _SIGNATURES[fn_name], device, *args)


def mhd_substep_wrap_cuda(fields: Fields, w: Optional[Fields], s: int, prm,
                          dt_phys: float, write_w: bool = True,
                          out_f: Optional[Fields] = None,
                          out_w: Optional[Fields] = None
                          ) -> Tuple[Fields, Optional[Fields]]:
    """B9: one fused RK3 substep ``s`` on 8 unpadded periodic (Z, Y, X)
    fields. Returns (new_fields, new_w); ``new_w`` is None when
    ``write_w=False``. ``w=None`` (only for ``alpha_s == 0``) skips the
    w read; ``write_w=False`` skips the w write — the dead-w elision of
    ``mhd_substep_wrap_pallas``. ``out_f``/``out_w``: destination
    tensors (default: new ones), which must not alias the inputs. One
    launch of the ring kernel over the whole field, each block walking
    ``ring_zrun`` z planes."""
    from ..models.astaroth import FIELDS, RK3_ALPHA

    what = "mhd_substep_wrap_cuda"
    f0 = _check_fields(fields, w, what)
    if w is None and float(RK3_ALPHA[s]) != 0.0:
        raise ValueError(f"{what}: w=None is only valid when alpha_s == 0 "
                         f"(substep {s} has alpha {RK3_ALPHA[s]})")
    if not write_w and out_w is not None:
        raise ValueError(f"{what}: out_w given with write_w=False")
    if f0.device.type == "cpu":
        nf, nw = mhd_substep_wrap_plain(fields, w, s, prm, dt_phys,
                                        write_w=write_w)
        return _copy_into(nf, out_f, f0, what), _copy_into(nw, out_w, f0,
                                                           what)
    out_f = _outputs(f0, out_f, what)
    out_w = _outputs(f0, out_w, what) if write_w else None
    ins = [fields[q] for q in FIELDS]
    w_in = [w[q] for q in FIELDS] if w is not None else []
    _check_cuda(f0, ins + w_in + list(out_f.values())
                + list((out_w or {}).values()), what)
    Z, Y, X = f0.shape
    zrun = ring_zrun(Z, Y, X, sm_count(f0.device))
    consts = kernel_consts(prm, dt_phys, s)
    # the pointer arrays are locals: they must outlive the call
    p_in, p_f = _ptrs(ins), _ptrs([out_f[q] for q in FIELDS])
    p_w = _ptrs(w_in) if w_in else None
    p_wo = _ptrs([out_w[q] for q in FIELDS]) if write_w else None
    _launch("mhd_substep_wrap_launch", f0.device, p_in, p_w, p_f, p_wo,
            Z, Y, X, zrun, consts.ctypes.data, consts.size, is_bf16(f0))
    LAUNCHES["mhd_substep_wrap"] += 1
    return out_f, out_w


def mhd_substep01_wrap_cuda(fields: Fields, prm, dt_phys: float,
                            out_f: Optional[Fields] = None,
                            out_w: Optional[Fields] = None
                            ) -> Tuple[Fields, Fields]:
    """B10: RK3 substeps 0 and 1 on 8 unpadded periodic (Z, Y, X) fields
    (alpha_0 == 0, so no w is read). Returns (f_2, w_2), which equal
    B9(s=0, ``w=None``) followed by B9(s=1) bit for bit: the wrapper
    launches just that, B9's ring kernel twice, through f_1 and w_1 in
    scratch from PyTorch's caching allocator (float32 for bfloat16
    fields, see the module's notes). ``out_f``/``out_w`` as for B9."""
    from ..models.astaroth import FIELDS

    what = "mhd_substep01_wrap_cuda"
    f0 = _check_fields(fields, None, what)
    if f0.device.type == "cpu":
        nf, nw = mhd_substep01_wrap_plain(fields, prm, dt_phys)
        return _copy_into(nf, out_f, f0, what), _copy_into(nw, out_w, f0,
                                                           what)
    out_f = _outputs(f0, out_f, what)
    out_w = _outputs(f0, out_w, what)
    ins = [fields[q] for q in FIELDS]
    _check_cuda(f0, ins + list(out_f.values()) + list(out_w.values()), what)
    Z, Y, X = f0.shape
    zrun = ring_zrun(Z, Y, X, sm_count(f0.device))
    consts = kernel_consts(prm, dt_phys)
    f1 = torch.empty((8, Z, Y, X), dtype=compute_dtype(f0.dtype),
                     device=f0.device)
    w1 = torch.empty_like(f1)
    # the pointer arrays are locals: they must outlive the call
    p_in, p_f = _ptrs(ins), _ptrs([out_f[q] for q in FIELDS])
    p_w = _ptrs([out_w[q] for q in FIELDS])
    p_f1, p_w1 = _ptrs(f1.unbind(0)), _ptrs(w1.unbind(0))
    _launch("mhd_substep01_wrap_launch", f0.device, p_in, p_f1, p_w1, p_f,
            p_w, Z, Y, X, zrun, consts.ctypes.data, consts.size,
            is_bf16(f0))
    LAUNCHES["mhd_substep01_wrap"] += 1
    return out_f, out_w


def _check_slabs(f0: torch.Tensor, slabs: Dict[str, Dict[str, torch.Tensor]],
                 rr: int, what: str) -> Tuple[int, int]:
    """The slabs' (rz, ry) after the layout checks of
    pallas_halo.py:896-899, widened to any row counts: per field ``zlo``
    and ``zhi`` (rz, Y, X), z-extended ``ylo`` and ``yhi`` (Z + 2rz, ry,
    X), each holding at least ``rr`` rows, all of the shard's dtype and
    device."""
    from ..models.astaroth import FIELDS

    if set(slabs) != set(FIELDS):
        raise ValueError(f"{what}: slabs must hold exactly {FIELDS}")
    Z, Y, X = f0.shape
    rz = slabs[FIELDS[0]]["zlo"].shape[0]
    ry = slabs[FIELDS[0]]["ylo"].shape[1]
    want = {"zlo": (rz, Y, X), "zhi": (rz, Y, X), "ylo": (Z + 2 * rz, ry, X),
            "yhi": (Z + 2 * rz, ry, X)}
    for q in FIELDS:
        if set(slabs[q]) != set(SLAB_NAMES):
            raise ValueError(f"{what}: slabs[{q!r}] must hold exactly "
                             f"{SLAB_NAMES}")
        for k, shape in want.items():
            t = slabs[q][k]
            if tuple(t.shape) != shape:
                raise ValueError(f"{what}: slab {q}/{k} has shape "
                                 f"{tuple(t.shape)}, expected {shape} (z "
                                 f"slabs (rz, Y, X), z-extended y slabs "
                                 f"(Z + 2rz, ry, X))")
            if t.dtype != f0.dtype or t.device != f0.device:
                raise ValueError(f"{what}: slab {q}/{k} is {t.dtype} on "
                                 f"{t.device}, the shard {f0.dtype} on "
                                 f"{f0.device}")
    if rz < rr or ry < rr:
        raise ValueError(f"{what}: slabs of {rz} z rows and {ry} y rows "
                         f"cannot feed a radius-{rr} window")
    return rz, ry


def _slab_list(slabs: Dict[str, Dict[str, torch.Tensor]]):
    """The 32 slab tensors in the launchers' order: all ``zlo``, then
    ``zhi``, ``ylo``, ``yhi``, each in FIELDS order."""
    from ..models.astaroth import FIELDS

    return [slabs[q][k] for k in SLAB_NAMES for q in FIELDS]


def _outputs(f0: torch.Tensor, out: Optional[Fields], what: str) -> Fields:
    """The destination fields of a launch: ``out`` after checking it
    (8 tensors of the shard's shape, dtype and device), else new ones."""
    from ..models.astaroth import FIELDS

    if out is None:
        return {q: torch.empty_like(f0) for q in FIELDS}
    if set(out) != set(FIELDS):
        raise ValueError(f"{what}: outputs must hold exactly {FIELDS}")
    for q, t in out.items():
        if (t.shape != f0.shape or t.dtype != f0.dtype
                or t.device != f0.device):
            raise ValueError(f"{what}: output {q!r} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{f0.dtype} {tuple(f0.shape)} on {f0.device}")
    return out


#: the ring kernel's block (B9, B11, B13's interior): 32 x 16 (x, y)
#: points walking a run of z planes, one block an SM (csrc/mhd_ring.cuh
#: RingTile)
RING_TILE_Y = 16


@functools.lru_cache(maxsize=None)
def ring_zrun(nz: int, ny: int, X: int, n_sms: int) -> int:
    """The z planes a block of the ring kernel walks over a region of nz
    planes, ny rows and X columns (a whole field or shard for B9 and
    B11, the interior for B13): the run that minimises waves x (run +
    2R), where a wave is one block on every SM and each run also loads
    2R planes of margin — long runs while the (x, y) tiles alone fill
    the card, shorter ones when they do not."""
    cols = -(-X // 32) * -(-ny // RING_TILE_Y)

    def cost(zrun):
        waves = -(-cols * -(-nz // zrun) // n_sms)
        return waves * (zrun + 2 * R), zrun

    return min(cost(-(-nz // runs)) for runs in range(1, nz + 1))[1]


class MarginPlan(NamedTuple):
    """The margin launch of B12 and of B14's pair on one (Z, Y, X) shard
    (``margin_plan``): the ints that the launchers copy into the
    kernel's MarginPlan (``csrc/mhd_margin.cuh``) as they are, the
    grid's column tiles and the floats a field of the margin buffer
    holds. A point (z, y, x)
    of a strip is written at ``off + z * zs + y * X + x`` of its field's
    buffer (``off`` the strip's, ``zs`` its kind's). Block row b counts
    the near z strip's tiles, the far one's, then the near and the far y
    strip's."""
    tz: int      # row tiles of a z strip (its Y rows of y)
    ty: int      # row tiles of a y strip (its Z + 2R rows of z)
    zlo: int     # output offset of the near z strip, z in [-R, 0)
    zhi: int     # ... of the far z strip, z in [Z, Z + R)
    ylo: int     # ... of the near y strip, y in [-R, 0)
    yhi: int     # ... of the far y strip, y in [Y, Y + R)
    zs: int      # z stride of the z strips' output
    ys: int      # z stride of the y strips' output
    cols: int    # column tiles of 32
    floats: int  # floats a field of the margin buffer

    def ints(self) -> np.ndarray:
        return np.asarray(self[:8], dtype=np.int32)

    @property
    def grid(self) -> Tuple[int, int]:
        return self.cols, 2 * (self.tz + self.ty)


@functools.lru_cache(maxsize=None)
def margin_layout(Z: int, Y: int, X: int) -> Dict[str, Tuple[int, tuple]]:
    """Where each R-row slab of B12's margin lies in a field's margin
    buffer: {name: (first float, shape)} in the layout of
    ``exchange_interior_slabs(rz=R, ry=R, y_z_extended=True)`` — ``zlo``
    and ``zhi`` (R, Y, X), ``ylo`` and ``yhi`` (Z + 2R, R, X) — one after
    another."""
    out, at = {}, 0
    for name in SLAB_NAMES:
        shape = (R, Y, X) if name[0] == "z" else (Z + 2 * R, R, X)
        out[name] = (at, shape)
        at += shape[0] * shape[1] * shape[2]
    return out


@functools.lru_cache(maxsize=None)
def margin_plan(Z: int, Y: int, X: int) -> MarginPlan:
    """B12's substep 0 around a (Z, Y, X) shard: the points within R of
    it that substep 1 reads, in the four strips of the R-row slab layout
    (``margin_layout``) — z in [-R, 0) and [Z, Z + R) at y in [0, Y),
    walked in z; y in [-R, 0) and [Y, Y + R) at z in [-R, Z + R), walked
    in y — each cut into tiles of 32 columns by ``RING_TILE_Y`` rows of
    its broad axis. The one source of the launcher, the tests and
    ``chip_smoke.py``."""
    lay = margin_layout(Z, Y, X)
    zs, ys = Y * X, R * X
    return MarginPlan(
        -(-Y // RING_TILE_Y), -(-(Z + 2 * R) // RING_TILE_Y),
        lay["zlo"][0] + R * zs, lay["zhi"][0] - Z * zs,
        lay["ylo"][0] + R * ys + R * X, lay["yhi"][0] + R * ys - Y * X,
        zs, ys, -(-X // 32),
        sum(a * b * c for _, (a, b, c) in lay.values()))


def margin_slabs(buf: torch.Tensor, Z: int, Y: int, X: int
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The R-row slabs (per field, views) of an (8, floats) margin
    buffer, in the layout ``margin_layout`` gives them."""
    from ..models.astaroth import FIELDS

    return {q: {k: buf[j, at:at + a * b * c].view(a, b, c)
                for k, (at, (a, b, c)) in margin_layout(Z, Y, X).items()}
            for j, q in enumerate(FIELDS)}


def margin_ptrs(buf: torch.Tensor, Z: int, Y: int, X: int
                ) -> Tuple[ctypes.Array, ctypes.Array]:
    """The launchers' pointers into an (8, floats) margin buffer: each
    field's buffer (8), and in them the R-row slabs that ``margin_slabs``
    views (32, in ``_slab_list`` order), by address: making the 32 views
    would be most of a wrapper's host work."""
    base = [buf.data_ptr() + j * buf.stride(0) * buf.element_size()
            for j in range(8)]
    return ((ctypes.c_void_p * 8)(*base),
            (ctypes.c_void_p * 32)(*[
                b + at * buf.element_size()
                for at, _ in margin_layout(Z, Y, X).values() for b in base]))


def _copy_into(got: Optional[Fields], out: Optional[Fields],
               f0: torch.Tensor, what: str) -> Optional[Fields]:
    """A twin's result, copied into ``out`` when the caller gave one."""
    if got is None or out is None:
        return got
    out = _outputs(f0, out, what)
    for q, t in got.items():
        out[q].copy_(t)
    return out


def mhd_substep_halo_cuda(fields: Fields, w: Optional[Fields],
                          slabs: Dict[str, Dict[str, torch.Tensor]], s: int,
                          prm, dt_phys: float, write_w: bool = True,
                          out_f: Optional[Fields] = None,
                          out_w: Optional[Fields] = None
                          ) -> Tuple[Fields, Optional[Fields]]:
    """B11: one fused RK3 substep ``s`` on 8 (Z, Y, X) shards of a
    z/y-sharded mesh, reading across the shard's z and y edges from
    ``slabs[q]`` (see ``halo_window``; radius R = 3 rows needed) and
    wrapping x. Returns (new_fields, new_w); ``new_w`` is None when
    ``write_w=False``. Dead-w elision as in B9: ``w=None`` (only for
    ``alpha_s == 0``) skips the w read, ``write_w=False`` the w write.
    ``out_f``/``out_w``: destination tensors (default: new ones), which
    must not alias the inputs. One launch, no scratch: the kernel reads
    the rows straight from the shard and the slabs into shared memory,
    each block walking ``ring_zrun`` z planes (B9's kernel, its margin
    rows read from the slabs)."""
    from ..models.astaroth import FIELDS, RK3_ALPHA

    what = "mhd_substep_halo_cuda"
    f0 = _check_fields(fields, w, what)
    if w is None and float(RK3_ALPHA[s]) != 0.0:
        raise ValueError(f"{what}: w=None is only valid when alpha_s == 0 "
                         f"(substep {s} has alpha {RK3_ALPHA[s]})")
    if not write_w and out_w is not None:
        raise ValueError(f"{what}: out_w given with write_w=False")
    rz, ry = _check_slabs(f0, slabs, R, what)
    if f0.device.type == "cpu":
        nf, nw = mhd_substep_halo_plain(fields, w, slabs, s, prm, dt_phys,
                                        write_w=write_w)
        return _copy_into(nf, out_f, f0, what), _copy_into(nw, out_w, f0,
                                                           what)
    out_f = _outputs(f0, out_f, what)
    out_w = _outputs(f0, out_w, what) if write_w else None
    ins = [fields[q] for q in FIELDS]
    w_in = [w[q] for q in FIELDS] if w is not None else []
    sl = _slab_list(slabs)
    outs = [out_f[q] for q in FIELDS]
    wo = [out_w[q] for q in FIELDS] if write_w else []
    _check_cuda(f0, ins + w_in + sl + outs + wo, what)
    Z, Y, X = f0.shape
    zrun = ring_zrun(Z, Y, X, sm_count(f0.device))
    consts = kernel_consts(prm, dt_phys, s)
    # the pointer arrays are locals: they must outlive the call
    p_in, p_sl, p_f = _ptrs(ins), _ptrs(sl), _ptrs(outs)
    p_w = _ptrs(w_in) if w_in else None
    p_wo = _ptrs(wo) if wo else None
    _launch("mhd_substep_halo_launch", f0.device, p_in, p_w, p_sl, p_f, p_wo,
            Z, Y, X, rz, ry, zrun, consts.ctypes.data, consts.size,
            is_bf16(f0))
    LAUNCHES["mhd_substep_halo"] += 1
    return out_f, out_w


def mhd_substep01_halo_cuda(fields: Fields,
                            slabs: Dict[str, Dict[str, torch.Tensor]], prm,
                            dt_phys: float, out_f: Optional[Fields] = None,
                            out_w: Optional[Fields] = None
                            ) -> Tuple[Fields, Fields]:
    """B12: RK3 substeps 0 and 1 on 8 (Z, Y, X) shards with slabs of 2R =
    6 valid rows (alpha_0 == 0, so no w is read). Returns (f_2, w_2),
    which equal B11(s=0, ``w=None``), a radius-R slab round, then B11(s=1)
    bit for bit: one call, three launches of the ring kernel on the
    caller's stream — B11 s=0 over the shard into f_1 and w_1, substep 0
    over the R rows around the shard from the same slabs into f_1's
    R-row slabs (``margin_plan``; the values the neighbours compute
    there), then B11 s=1 from them. f_1, w_1 and the margin are scratch
    from PyTorch's caching allocator (float32 for bfloat16 fields).
    ``out_f``/``out_w`` as for ``mhd_substep_halo_cuda``."""
    from ..models.astaroth import FIELDS

    what = "mhd_substep01_halo_cuda"
    f0 = _check_fields(fields, None, what)
    rz, ry = _check_slabs(f0, slabs, 2 * R, what)
    if f0.device.type == "cpu":
        nf, nw = mhd_substep01_halo_plain(fields, slabs, prm, dt_phys)
        return _copy_into(nf, out_f, f0, what), _copy_into(nw, out_w, f0,
                                                           what)
    out_f = _outputs(f0, out_f, what)
    out_w = _outputs(f0, out_w, what)
    ins = [fields[q] for q in FIELDS]
    sl = _slab_list(slabs)
    outs = [out_f[q] for q in FIELDS]
    wo = [out_w[q] for q in FIELDS]
    _check_cuda(f0, ins + sl + outs + wo, what)
    Z, Y, X = f0.shape
    if (Z + 4 * R) * (Y + 4 * R) * X >= 2 ** 31:
        raise ValueError(f"{what}: shards whose radius-{2 * R} window holds "
                         f"2^31 points or more are not supported (32-bit "
                         f"offsets)")
    zrun = ring_zrun(Z, Y, X, sm_count(f0.device))
    plan = margin_plan(Z, Y, X)
    ints = plan.ints()
    consts = kernel_consts(prm, dt_phys)
    comp = compute_dtype(f0.dtype)
    f1 = torch.empty((8, Z, Y, X), dtype=comp, device=f0.device)
    w1 = torch.empty_like(f1)
    margin = torch.empty((8, plan.floats), dtype=comp, device=f0.device)
    # the pointer arrays are locals: they must outlive the call
    p_in, p_sl, p_f, p_w = _ptrs(ins), _ptrs(sl), _ptrs(outs), _ptrs(wo)
    p_f1, p_w1 = _ptrs(f1.unbind(0)), _ptrs(w1.unbind(0))
    p_m, p_sl1 = margin_ptrs(margin, Z, Y, X)
    _launch("mhd_substep01_halo_launch", f0.device, p_in, p_sl, p_f1, p_w1,
            p_m, p_sl1, p_f, p_w, Z, Y, X, rz, ry, zrun, ints.ctypes.data,
            ints.size, plan.floats, consts.ctypes.data, consts.size,
            is_bf16(f0))
    LAUNCHES["mhd_substep01_halo"] += 1
    return out_f, out_w
