"""The ``cuda.`` targets: the checkers run over the port's kernels on the
card (sm_90). Off the card each is skipped with a metric that says why
(``analysis.run_targets``); on it, each also proves it ran a kernel (a
launch count that grows), so that none passes vacuously.

* footprint: K3 and B8 (float32 and bfloat16) through the padded probe
  with an allocation one row deeper than the stencil's radius; B5, B6
  (N = 2) and B11 (s = 0) fed JAX's rz = ry = 8 slabs, their filler
  poisoned;
* vmem: the ``-Xptxas=-v`` usage of every library that defines a kernel
  (``ops/_build.usage``);
* tiling: the card's blocks an SM at the planned launches of B8 (both
  dtypes), the ring kernel of K2/B6 (N = 1..8, both dtypes) and B14;
* donation and transfer: the ``wrap`` segment (K1, K2), ``pallas`` with
  ``PallasDMA`` (K3, B4) and the certified ``overlap`` segment (B7) on
  four shards of one card, the transfer guard armed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from ..geometry import Dim3, Radius
from .footprint import (SlabKernelSpec, SlabKernelTarget, StencilOpSpec,
                        StencilOpTarget, slab_regions)

CARD = "cuda"


@dataclasses.dataclass
class CardTarget:
    """A target that runs only on an sm_90 card (``inner`` is the
    checker's own target)."""
    inner: object

    card = True

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def checker(self) -> str:
        return self.inner.checker


def _padded(kind: str, dtype: torch.dtype) -> StencilOpSpec:
    """K3 ("jacobi7") or B8 ("laplace6") on a 16 x 12 x 20 interior,
    padded one row deeper than the stencil's radius."""
    from ..ops import cuda_stencil as cs

    r = 1 if kind == "jacobi7" else 3
    alloc = Radius.constant(r + 1)
    interior = Dim3(20, 12, 16)
    shape = (16 + 2 * r + 2, 12 + 2 * r + 2, 20 + 2 * r + 2)
    if kind == "jacobi7":
        def fn(p):
            return cs.jacobi7_padded_cuda(p, alloc, interior)
        key = "jacobi7_padded"
    else:
        inv = (1.0 / 0.049, 1.0 / 0.05, 1.0 / 0.047)

        def fn(p):
            return cs.laplace6_cuda(p, alloc, interior, inv)
        key = "laplace6"
    return StencilOpSpec(fn, shape, Radius.constant(r), interior,
                         pad_lo=Dim3(r + 1, r + 1, r + 1), dtype=dtype,
                         device=CARD, launches=lambda: cs.LAUNCHES[key])


def _rand(shape, seed: int, scale: float = 1.0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=gen)).to(dtype).to(CARD)


def _jacobi_slab_spec(steps: int) -> SlabKernelSpec:
    """B5 (``steps`` 1) or B6 (``steps`` > 1) on a 16^3 shard with rz =
    ry = 8 slabs (z-extended y slabs for B6)."""
    from ..ops import cuda_halo as ch

    Z = Y = X = 16
    rz = e = 8
    zext = steps > 1
    zs = Z + 2 * rz if zext else Z
    hot, cold = (X // 3, Y // 2, Z // 2), (2 * X // 3, Y // 2, Z // 2)

    def make():
        interior = _rand((Z, Y, X), 1)
        slabs = {"zlo": _rand((rz, Y, X), 2), "zhi": _rand((rz, Y, X), 3),
                 "ylo": _rand((zs, e, X), 4), "yhi": _rand((zs, e, X), 5)}
        regions = [(k, t) + slab_regions(k, t, steps,
                                         rz if zext else 0, Z)
                   for k, t in slabs.items()]
        return (interior, slabs), regions

    if steps == 1:
        def fn(interior, slabs):
            return ch.jacobi7_halo_cuda(interior, slabs, (0, 0, 0), hot,
                                        cold, 1)
        key = "jacobi7_halo"
    else:
        def fn(interior, slabs):
            return ch.jacobi7_halon_cuda(interior, slabs, (0, 0, 0),
                                         (Z, Y, X), hot, cold, 1,
                                         steps=steps)
        key = "jacobi7_halon"
    return SlabKernelSpec(fn, make, lambda: ch.LAUNCHES[key])


def _b11_spec() -> SlabKernelSpec:
    """B11 substep 0 on a 16 x 16 x 32 shard of small random fields, rz
    = ry = 8 z-extended slabs a field."""
    from ..models.astaroth import FIELDS, MhdParams
    from ..ops import cuda_mhd as cm

    Z, Y, X = 16, 16, 32
    rz = ry = 8
    prm = MhdParams()

    def make():
        fields = {q: _rand((Z, Y, X), 10 + k, 0.01)
                  for k, q in enumerate(FIELDS)}
        slabs, regions = {}, []
        for k, q in enumerate(FIELDS):
            slabs[q] = {
                "zlo": _rand((rz, Y, X), 100 + k, 0.01),
                "zhi": _rand((rz, Y, X), 200 + k, 0.01),
                "ylo": _rand((Z + 2 * rz, ry, X), 300 + k, 0.01),
                "yhi": _rand((Z + 2 * rz, ry, X), 400 + k, 0.01)}
            regions += [(f"{q}/{s}", t) + slab_regions(s, t, cm.R, rz, Z)
                        for s, t in slabs[q].items()]
        return (fields, slabs), regions

    def fn(fields, slabs):
        return cm.mhd_substep_halo_cuda(fields, None, slabs, 0, prm,
                                        prm.dt)

    return SlabKernelSpec(fn, make,
                          lambda: cm.LAUNCHES["mhd_substep_halo"])


def footprint_targets() -> List[CardTarget]:
    out = []
    for kind, wrapper in (("jacobi7", "jacobi7_padded_cuda"),
                          ("laplace6", "laplace6_cuda")):
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            out.append(CardTarget(StencilOpTarget(
                f"cuda.footprint.ops.cuda_stencil.{wrapper}[{tag}]",
                lambda k=kind, d=dt: _padded(k, d))))
    out.append(CardTarget(SlabKernelTarget(
        "cuda.footprint.ops.cuda_halo.jacobi7_halo_cuda",
        lambda: _jacobi_slab_spec(1))))
    out.append(CardTarget(SlabKernelTarget(
        "cuda.footprint.ops.cuda_halo.jacobi7_halon_cuda[n=2]",
        lambda: _jacobi_slab_spec(2))))
    out.append(CardTarget(SlabKernelTarget(
        "cuda.footprint.ops.cuda_mhd.mhd_substep_halo_cuda[s=0]",
        _b11_spec)))
    return out


def build_targets() -> List[CardTarget]:
    from ..ops import _build
    from .vmem import BuildTarget

    # every library that defines a kernel (ipc.cu's flags are stream
    # memory operations, no kernel of its own)
    return [CardTarget(BuildTarget(f"cuda.vmem.ptxas[{lib}]", lib))
            for lib in sorted(_build.sources())
            if any("__global__" in f.read_text()
                   for f in _build.source_files(lib))]


def occupancy_targets() -> List[CardTarget]:
    from ..ops import cuda_mhd_overlap as mo
    from ..ops import cuda_stencil as cs
    from .tiling import PLAN_SMS
    from .vmem import OccupancyTarget

    dev = torch.device(CARD)
    out = []
    for tag, isz in (("f32", 4), ("bf16", 2)):
        out.append(CardTarget(OccupancyTarget(
            f"cuda.tiling.occupancy[laplace6,{tag}]",
            lambda i=isz: cs.laplace6_occupancy(dev, i),
            cs.laplace6_blocks_per_sm(), cs.LAPLACE6_SMEM_BYTES)))
        for n in range(1, cs.RING_MAX_STEPS + 1):
            p = cs.jacobi_ring_plan(256, 256, 256, n, PLAN_SMS, isz)
            out.append(CardTarget(OccupancyTarget(
                f"cuda.tiling.occupancy[jacobi_ring,N={n},{tag}]",
                lambda n=n, p=p, i=isz: cs.ring_occupancy(dev, n, p.ty,
                                                          p.depth, i),
                p.blocks_per_sm,
                cs.ring_smem_bytes(n, p.ty, p.depth, isz)
                + cs.RING_STATIC_BYTES)))
    out.append(CardTarget(OccupancyTarget(
        "cuda.tiling.occupancy[mhd_shell]",
        lambda: mo.fixup_occupancy(dev), mo.FIXUP_BLOCKS_PER_SM, 0)))
    return out


def _counted(build: Callable, keys) -> Callable:
    """``build``'s DispatchSpec with its launch counters (``keys``: (the
    module's LAUNCHES, name) pairs), which the checkers require to
    grow."""
    def make():
        spec = build()
        spec.launches = lambda: sum(d[k] for d, k in keys)
        return spec
    return make


def dispatch_targets() -> List[CardTarget]:
    from ..ops import cuda_exchange as cx
    from ..ops import cuda_overlap as co
    from ..ops import cuda_stencil as cs
    from ..parallel.methods import Method
    from .donation import DonationTarget
    from .entries import jacobi_dispatch
    from .transfer import TransferTarget

    # five steps: chunks of 2, 2 and 1, so that K2 and K1 both launch
    wrap = _counted(lambda: jacobi_dispatch(
        "wrap", segment=5, device=CARD, size=64, mesh=(1, 1, 1)),
        [(cs.LAUNCHES, "jacobi7_wrapn"), (cs.LAUNCHES, "jacobi7_wrap")])
    pallas = _counted(lambda: jacobi_dispatch(
        "pallas", device=CARD, size=64, methods=Method.PallasDMA),
        [(cs.LAUNCHES, "jacobi7_padded"), (cx.LAUNCHES, "exchange_axis")])
    overlap = _counted(lambda: jacobi_dispatch(
        "overlap", segment=4, device=CARD, size=64),
        [(co.LAUNCHES, "jacobi7_overlap")])
    out = []
    for name, build in (("models.jacobi.segment[wrap,k=5]", wrap),
                        ("models.jacobi.step_n[pallas,PallasDMA]", pallas),
                        ("models.jacobi.segment[overlap,k=4]", overlap)):
        out.append(CardTarget(DonationTarget(f"cuda.donation.{name}",
                                             build)))
        out.append(CardTarget(TransferTarget(f"cuda.transfer.{name}",
                                             build)))
    return out


def card_targets() -> List[CardTarget]:
    return (footprint_targets() + build_targets() + occupancy_targets()
            + dispatch_targets())
