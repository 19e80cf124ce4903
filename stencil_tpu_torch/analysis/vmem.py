"""Checker 6: each kernel's launch fits a Hopper block at its own small
shape.

PyTorch-port counterpart of ``stencil_tpu/analysis/vmem.py`` (each
Pallas kernel's VMEM footprint, (8, 128) tiling and grid divisibility).
Hopper's budgets take the TPU's place: the port's plan of each of JAX's
kernels (``tiling.PLANS``) at a shard of 8 x 12 x 20 cells — smaller
than one tile along some axes, ragged along all — asks for at most the
227 KB of shared memory a block may use, holds a block an SM, keeps
registers x threads within an SM's 65,536 where the plan models them,
and its tiles cover the shard once. On the card the ``cuda.`` targets
read what the build made (``ops/_build.ptxas_usage``: registers,
spills, static shared memory) and what the runtime says
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from .report import ERROR, Finding
from .tiling import TilePlan, check_plan, grid

#: the ragged shard (z, y, x) of the vmem targets
SMALL = (8, 12, 20)


def small_plan(build: Callable[[int], TilePlan]) -> TilePlan:
    """``build``'s plan made at a cube of the largest side, then cut to
    the ragged ``SMALL`` shard (the plans' tiles do not depend on the
    other axes' extents)."""
    plan = build(max(SMALL))
    tiles = []
    region = []
    for a, n in enumerate(SMALL):
        (lo, hi), ivs = plan.region[a], plan.tiles[a]
        if (lo, hi) == (0, 1):          # a plan without a region
            tiles.append(ivs)
            region.append((lo, hi))
            continue
        step = max(e - s for s, e in ivs)
        lo2, hi2 = min(lo, n), n - (max(SMALL) - hi)
        if hi2 <= lo2:
            tiles.append(())
            region.append((lo2, lo2))
            continue
        tiles.append(grid(lo2, hi2, step))
        region.append((lo2, hi2))
    return dataclasses.replace(plan, region=tuple(region),
                               tiles=tuple(tiles))


@dataclasses.dataclass
class VmemTarget:
    name: str
    build: Callable[[], TilePlan]

    checker = "vmem"


def check_vmem(target: VmemTarget):
    try:
        plan = target.build()
    except Exception as e:  # noqa: BLE001
        return [Finding("vmem", target.name,
                        f"planning failed: {type(e).__name__}: {e}")]
    return check_plan(target.name, "vmem", plan), plan.to_dict()


# ---------------------------------------------------------------------------
# the card: what the build and the runtime say
# ---------------------------------------------------------------------------
def card_available() -> Optional[str]:
    """None when an sm_90 card is here, else why the ``cuda.`` targets
    skip."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device"
    major, minor = torch.cuda.get_device_capability(0)
    if major != 9:
        return f"compute capability {major}.{minor}, not sm_90"
    return None


@dataclasses.dataclass
class BuildTarget:
    """The ``-Xptxas=-v`` usage of every kernel of library ``lib``
    (a fresh build's log where this process did not build it)."""
    name: str
    lib: str
    card = True

    checker = "vmem"


def check_build(target: BuildTarget):
    import torch

    from ..ops import _build

    use = _build.usage(target.lib)
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    findings: List[Finding] = []
    if not use:
        return [Finding("vmem", target.name,
                        f"no -Xptxas=-v lines for {target.lib}: nothing "
                        f"read")]
    for (lib, name), u in sorted(use.items()):
        short = name[:60]
        regs = u.get("registers", 0)
        if regs > 255:
            findings.append(Finding("vmem", target.name,
                                    f"{short}: {regs} registers > 255"))
        spills = (u.get("spill_stores", 0), u.get("spill_loads", 0))
        if spills != (0, 0):
            findings.append(Finding(
                "vmem", target.name,
                f"{short}: spill stores/loads {spills} B (PERF.md states "
                f"no spill for any kernel)"))
        if u.get("static_smem", 0) > 48 * 1024 \
                or u.get("static_smem", 0) > limit:
            findings.append(Finding(
                "vmem", target.name,
                f"{short}: {u.get('static_smem')} B of static shared "
                f"memory"))
    return findings, {"kernels": len(use),
                      "max_registers": max(u.get("registers", 0)
                                           for u in use.values()),
                      "spilling": sum(u.get("spill_stores", 0) > 0
                                      for u in use.values()),
                      "smem_optin": limit}


@dataclasses.dataclass
class OccupancyTarget:
    """``occupancy()`` the card's blocks an SM at a planned launch,
    ``model`` the plan's; both >= 1 and equal."""
    name: str
    occupancy: Callable[[], int]
    model: int
    dynamic: int
    card = True

    checker = "tiling"


def check_occupancy(target: OccupancyTarget):
    import torch

    from ..ops import cuda_stencil as cs

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    got = target.occupancy()
    findings = []
    if got < 1:
        findings.append(Finding("tiling", target.name,
                                "the card holds no block of the planned "
                                "launch", ERROR))
    elif got != target.model:
        findings.append(Finding(
            "tiling", target.name,
            f"the card holds {got} blocks an SM, the plan models "
            f"{target.model}"))
    if target.dynamic > limit or target.dynamic > cs.BLOCK_SMEM_BYTES:
        findings.append(Finding(
            "tiling", target.name,
            f"{target.dynamic} B of dynamic shared memory > the card's "
            f"{limit} B a block"))
    return findings, {"card_blocks_per_sm": got, "model": target.model,
                      "dynamic_smem": target.dynamic, "smem_optin": limit}
