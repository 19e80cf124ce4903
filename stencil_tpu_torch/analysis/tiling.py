"""Checker 10: each kernel's launch plan fits Hopper and covers its
output exactly once, at 256^3 and 512^3 a shard.

PyTorch-port counterpart of ``stencil_tpu/analysis/tiling.py`` (the
prescriptive VMEM planner). On the TPU the scarce budget is VMEM; on
Hopper it is the 227 KB of shared memory a block may ask for (and the
registers, which ``vmem`` and the card targets read). The port's
planners are ``ops/cuda_stencil.jacobi_ring_plan`` (K2, B6),
``laplace6_plan`` (B8), ``ops/cuda_mhd.ring_zrun`` (the MHD ring of
B9-B13) and ``ops/cuda_mhd_overlap.interior_plan`` (B13's interior);
the other kernels launch the fixed blocks of their source
(``kBX``/``kBY``/``kZRun``, read from ``csrc/``). For each of JAX's
kernels (by its name) at a shard of 256^3 or 512^3 a target builds the
port's plan and holds:

* the dynamic shared memory it asks for plus the kernel's static tables
  within ``BLOCK_SMEM_BYTES`` (227 KB), and its blocks an SM >= 1;
* its blocks cover every output cell once: along each axis the tiles'
  intervals partition the region (their product then partitions the
  box);
* the verdict (dynamic bytes, blocks an SM, z run) equals the pinned
  table ``TILING_EXPECT``, so that a planner change shows.

``python -m stencil_tpu_torch.analysis --plan-tiling GLOB`` prints the
plans.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .report import Finding

#: the card the plans are made for (an H100's SMs)
PLAN_SMS = 132
SIZES = (256, 512)
CSRC = Path(__file__).resolve().parent.parent / "csrc"


@functools.lru_cache(maxsize=None)
def csrc_constant(source: str, name: str) -> int:
    """``constexpr int <name> = <int>;`` of ``csrc/<source>``."""
    text = (CSRC / source).read_text()
    m = re.search(rf"constexpr int {name}\s*=\s*(\d+)\s*;", text)
    if m is None:
        raise KeyError(f"no constexpr int {name} in csrc/{source}")
    return int(m.group(1))


@dataclasses.dataclass
class TilePlan:
    """One kernel's launch over its output region (z, y, x):
    ``tiles[a]`` the (start, stop) intervals of its blocks along axis a
    (z, y, x order), ``region[a]`` the (start, stop) it must cover;
    ``dynamic`` and ``static`` shared-memory bytes a block, ``threads``
    a block, ``blocks_per_sm`` the plan's model, ``zrun``."""
    kernel: str
    region: Tuple[Tuple[int, int], ...]
    tiles: Tuple[Tuple[Tuple[int, int], ...], ...]
    dynamic: int
    static: int
    threads: int
    blocks_per_sm: int
    zrun: int
    registers: Optional[int] = None
    note: str = ""

    def verdict(self) -> Tuple[int, int, int]:
        return (self.dynamic, self.blocks_per_sm, self.zrun)

    def to_dict(self) -> dict:
        return {"kernel": self.kernel, "dynamic_smem": self.dynamic,
                "static_smem": self.static, "threads": self.threads,
                "blocks_per_sm": self.blocks_per_sm, "zrun": self.zrun,
                "tiles": [len(t) for t in self.tiles],
                "registers": self.registers, "note": self.note}


def grid(start: int, stop: int, step: int) -> Tuple[Tuple[int, int], ...]:
    """The intervals of blocks of ``step`` from ``start``, the last one
    clipped at ``stop`` (the kernels mask their ragged edge)."""
    return tuple((s, min(s + step, stop)) for s in range(start, stop, step))


def partition_errors(plan: TilePlan) -> List[str]:
    out = []
    for a, (ivs, (lo, hi)) in enumerate(zip(plan.tiles, plan.region)):
        pos = lo
        for s, e in sorted(ivs):
            if s != pos or e <= s:
                out.append(f"axis {'zyx'[a]}: tiles leave a gap or "
                           f"overlap at {pos} (next tile [{s}, {e}))")
                break
            pos = e
        else:
            if pos != hi:
                out.append(f"axis {'zyx'[a]}: tiles end at {pos}, the "
                           f"region at {hi}")
    return out


def _fixed(kernel: str, source: str, n: int, cells_x: int = 1
           ) -> TilePlan:
    """A kernel of fixed kBX x kBY blocks walking kZRun planes (K1, K3,
    B5, B7's inner launch); ``cells_x`` cells a thread along x (2 in
    the bf16 instances)."""
    bx, by = csrc_constant(source, "kBX"), csrc_constant(source, "kBY")
    zr = csrc_constant(source, "kZRun")
    return TilePlan(kernel, ((0, n),) * 3,
                    (grid(0, n, zr), grid(0, n, by),
                     grid(0, n, bx * cells_x)), 0, 0, bx * by,
                    _threads_bound(bx * by), zr)


def _threads_bound(threads: int) -> int:
    # an SM runs at most 2048 threads and 32 blocks
    return min(2048 // threads, 32)


def k2_plan(n: int, steps: int, itemsize: int = 4,
            kernel: str = "K2") -> TilePlan:
    from ..ops import cuda_stencil as cs

    p = cs.jacobi_ring_plan(n, n, n, steps, PLAN_SMS, itemsize)
    return TilePlan(kernel, ((0, n),) * 3,
                    (grid(0, n, p.zrun), grid(0, n, p.ty),
                     grid(0, n, cs.RING_TILE_X)),
                    cs.ring_smem_bytes(steps, p.ty, p.depth, itemsize),
                    cs.RING_STATIC_BYTES, cs.RING_THREADS,
                    p.blocks_per_sm, p.zrun, cs.ring_registers(itemsize),
                    f"ty={p.ty} depth={p.depth}")


def b8_plan(n: int) -> TilePlan:
    from ..ops import cuda_stencil as cs

    p = cs.laplace6_plan(n, n, n, PLAN_SMS)
    return TilePlan("B8", ((0, n),) * 3,
                    (grid(0, n, p.zrun), grid(0, n, cs.LAPLACE6_TY),
                     grid(0, n, cs.RING_TILE_X)),
                    cs.LAPLACE6_SMEM_BYTES, 0, cs.LAPLACE6_THREADS,
                    p.blocks_per_sm, p.zrun, cs.LAPLACE6_REGISTERS)


def _mhd_ring_smem() -> int:
    """``RingTile::kSmem`` of csrc/mhd_ring.cuh: 8 ring slots of the 8
    fields' (kBX + 2R) x (kTY + 2R) slices."""
    from ..ops import cuda_mhd as cm

    bx = csrc_constant("mhd_common.cuh", "kBX")
    ring = csrc_constant("mhd_ring.cuh", "kRing")
    return 4 * ring * 8 * (bx + 2 * cm.R) * (cm.RING_TILE_Y + 2 * cm.R)


def mhd_ring_plan(kernel: str, n: int, region=None) -> TilePlan:
    """The MHD ring kernel (B9, B11, B13's interior) over a region of an
    n^3 shard: 32 x 16 tiles walking ``ring_zrun`` planes."""
    from ..ops import cuda_mhd as cm

    (z0, z1), (y0, y1) = region or ((0, n), (0, n))
    zrun = cm.ring_zrun(z1 - z0, y1 - y0, n, PLAN_SMS)
    bx = csrc_constant("mhd_common.cuh", "kBX")
    return TilePlan(kernel, ((z0, z1), (y0, y1), (0, n)),
                    (grid(z0, z1, zrun), grid(y0, y1, cm.RING_TILE_Y),
                     grid(0, n, bx)), _mhd_ring_smem(), 0,
                    bx * cm.RING_TILE_Y, 1, zrun)


def b13_plan(n: int) -> TilePlan:
    from ..ops import cuda_mhd_overlap as mo

    (z0, nz, y0, ny, _), = mo.interior_plan(n, n, n, False, PLAN_SMS)
    return mhd_ring_plan("B13", n, ((int(z0), int(z0 + nz)),
                                    (int(y0), int(y0 + ny))))


def b4_plan(n: int) -> TilePlan:
    """B4 copies the rows of its launch table (no shared memory); its
    coverage is the table's (``tests/test_torch_exchange_table.py``),
    here the region is one block a slab row."""
    threads = csrc_constant("exchange_dma.cu", "kThreads")
    return TilePlan("B4", ((0, 1),) * 3, (((0, 1),),) * 3, 0, 0, threads,
                    _threads_bound(threads), 1,
                    note="coverage: the launch table's rows")


#: JAX's kernel name -> the port's plan at an n^3 shard
PLANS: Dict[str, Callable[[int], TilePlan]] = {
    "parallel.pallas_exchange.exchange_shard_pallas": b4_plan,
    "ops.pallas_overlap.jacobi7_overlap_pallas":
        lambda n: _fixed("B7", "jacobi_overlap.cu", n),
    "ops.pallas_mhd_overlap.mhd_substep_overlap": b13_plan,
    "ops.pallas_halo.jacobi7_halo_pallas":
        lambda n: _fixed("B5", "jacobi_halo.cu", n),
    "ops.pallas_stencil.jacobi7_pallas":
        lambda n: _fixed("K3", "jacobi7.cu", n),
    "ops.pallas_stencil.laplace6_pallas": b8_plan,
    "ops.pallas_stencil.jacobi7_wrap_pallas":
        lambda n: _fixed("K1", "jacobi7.cu", n),
    "ops.pallas_stencil.jacobi7_wrapn_pallas[n=2]": lambda n: k2_plan(n, 2),
    "ops.pallas_stencil.jacobi7_wrapn_pallas[n=4]": lambda n: k2_plan(n, 4),
    "ops.pallas_mhd.mhd_substep_wrap_pallas":
        lambda n: mhd_ring_plan("B9", n),
    "ops.pallas_mhd.mhd_substep01_wrap_pallas":
        lambda n: mhd_ring_plan("B10", n),
    "ops.pallas_halo.jacobi7_halon_pallas[n=2]":
        lambda n: k2_plan(n, 2, kernel="B6"),
    "ops.pallas_halo.mhd_substep_halo_pallas":
        lambda n: mhd_ring_plan("B11", n),
    "ops.pallas_halo.mhd_substep01_halo_pallas":
        lambda n: mhd_ring_plan("B12", n),
}

#: the pinned verdicts: (kernel, shard side) -> (dynamic shared bytes,
#: blocks an SM, z run); the port's ``_TILING_EXPECT``
TILING_EXPECT: Dict[Tuple[str, int], Tuple[int, int, int]] = {
    ("parallel.pallas_exchange.exchange_shard_pallas", 256): (0, 8, 1),
    ("parallel.pallas_exchange.exchange_shard_pallas", 512): (0, 8, 1),
    ("ops.pallas_overlap.jacobi7_overlap_pallas", 256): (0, 8, 16),
    ("ops.pallas_overlap.jacobi7_overlap_pallas", 512): (0, 8, 16),
    ("ops.pallas_mhd_overlap.mhd_substep_overlap", 256): (214016, 1, 250),
    ("ops.pallas_mhd_overlap.mhd_substep_overlap", 512): (214016, 1, 506),
    ("ops.pallas_halo.jacobi7_halo_pallas", 256): (0, 8, 16),
    ("ops.pallas_halo.jacobi7_halo_pallas", 512): (0, 8, 16),
    ("ops.pallas_stencil.jacobi7_pallas", 256): (0, 8, 16),
    ("ops.pallas_stencil.jacobi7_pallas", 512): (0, 8, 16),
    ("ops.pallas_stencil.laplace6_pallas", 256): (69120, 2, 32),
    ("ops.pallas_stencil.laplace6_pallas", 512): (69120, 2, 256),
    ("ops.pallas_stencil.jacobi7_wrap_pallas", 256): (0, 8, 16),
    ("ops.pallas_stencil.jacobi7_wrap_pallas", 512): (0, 8, 16),
    ("ops.pallas_stencil.jacobi7_wrapn_pallas[n=2]", 256): (103680, 2, 32),
    ("ops.pallas_stencil.jacobi7_wrapn_pallas[n=2]", 512): (103680, 2, 256),
    ("ops.pallas_stencil.jacobi7_wrapn_pallas[n=4]", 256): (218880, 1, 64),
    ("ops.pallas_stencil.jacobi7_wrapn_pallas[n=4]", 512): (218880, 1, 512),
    ("ops.pallas_mhd.mhd_substep_wrap_pallas", 256): (214016, 1, 256),
    ("ops.pallas_mhd.mhd_substep_wrap_pallas", 512): (214016, 1, 512),
    ("ops.pallas_mhd.mhd_substep01_wrap_pallas", 256): (214016, 1, 256),
    ("ops.pallas_mhd.mhd_substep01_wrap_pallas", 512): (214016, 1, 512),
    ("ops.pallas_halo.jacobi7_halon_pallas[n=2]", 256): (103680, 2, 32),
    ("ops.pallas_halo.jacobi7_halon_pallas[n=2]", 512): (103680, 2, 256),
    ("ops.pallas_halo.mhd_substep_halo_pallas", 256): (214016, 1, 256),
    ("ops.pallas_halo.mhd_substep_halo_pallas", 512): (214016, 1, 512),
    ("ops.pallas_halo.mhd_substep01_halo_pallas", 256): (214016, 1, 256),
    ("ops.pallas_halo.mhd_substep01_halo_pallas", 512): (214016, 1, 512),
}


@dataclasses.dataclass
class TilingTarget:
    """``build()`` gives the plan; ``expect`` the pinned verdict (None:
    unpinned)."""
    name: str
    build: Callable[[], TilePlan]
    expect: Optional[Tuple[int, int, int]] = None
    budget: Optional[int] = None

    checker = "tiling"


def check_plan(name: str, checker: str, plan: TilePlan,
               budget: Optional[int] = None) -> List[Finding]:
    from ..ops import cuda_stencil as cs

    budget = cs.BLOCK_SMEM_BYTES if budget is None else budget
    out = []
    if plan.dynamic + plan.static > budget:
        out.append(Finding(
            checker, name,
            f"{plan.kernel}: {plan.dynamic} B dynamic + {plan.static} B "
            f"static shared memory a block exceeds the {budget} B a "
            f"Hopper block may use"))
    if plan.blocks_per_sm < 1:
        out.append(Finding(checker, name,
                           f"{plan.kernel}: no block fits an SM"))
    if plan.registers is not None \
            and plan.registers * plan.threads > cs.SM_REGISTERS:
        out.append(Finding(
            checker, name,
            f"{plan.kernel}: {plan.registers} registers x {plan.threads} "
            f"threads exceed an SM's {cs.SM_REGISTERS}"))
    out += [Finding(checker, name, f"{plan.kernel}: {m}")
            for m in partition_errors(plan)]
    return out


def check_tiling(target: TilingTarget):
    try:
        plan = target.build()
    except Exception as e:  # noqa: BLE001
        return [Finding("tiling", target.name,
                        f"planning failed: {type(e).__name__}: {e}")]
    findings = check_plan(target.name, "tiling", plan, target.budget)
    if target.expect is not None and plan.verdict() != target.expect:
        findings.append(Finding(
            "tiling", target.name,
            f"{plan.kernel}: verdict (dynamic B, blocks/SM, z run) "
            f"{plan.verdict()} != the pinned {target.expect}: the plan "
            f"changed"))
    return findings, plan.to_dict()


def plan_tiling_report(targets: Sequence[TilingTarget]) -> List[dict]:
    return [dict(name=t.name, **t.build().to_dict()) for t in targets]


def render_plan_table(rows: Sequence[dict]) -> str:
    lines = [f"{'target':<72} {'kernel':<6} {'dyn B':>7} {'stat B':>7} "
             f"{'thr':>4} {'b/SM':>4} {'zrun':>4}  tiles (z, y, x)"]
    for r in rows:
        lines.append(f"{r['name']:<72} {r['kernel']:<6} "
                     f"{r['dynamic_smem']:>7} {r['static_smem']:>7} "
                     f"{r['threads']:>4} {r['blocks_per_sm']:>4} "
                     f"{r['zrun']:>4}  {tuple(r['tiles'])} {r['note']}")
    return "\n".join(lines)
