"""The one decision of the JAX block planner that the halo path copies.

The JAX model groups the ``halo`` path's steps into N-step launches of
``jacobi7_halon_pallas`` only when ``fit_pair_halo_blocks``
(``stencil_tpu/ops/pallas_halo.py:302`` -> ``analysis/tiling.py:134``)
finds a legal (block_z, block_y) for the TPU's VMEM; otherwise every
step runs the single-step kernel (``models/jacobi.py:847-865``). The two
kernels add in different orders, so the port must group steps exactly
where JAX does, or the paths stop agreeing bitwise. This module copies
that legality test as integer arithmetic. It does not copy the block
choice: the CUDA kernels pick their own tiling.
"""

from __future__ import annotations

from typing import Optional

#: the planner's selection budget (``analysis/tiling.py``
#: ``TILE_SELECT_BUDGET_BYTES``): the TPU's VMEM less slack
TILE_SELECT_BUDGET_BYTES = 14 * 2 ** 20
#: the pair kernel's ceilings (``fit_pair_halo_blocks``: cap_z, cap_y)
CAP_Z = 16
CAP_Y = 128


def _pair_footprint(bz: int, by: int, X: int, itemsize: int, esub: int,
                    steps: int) -> int:
    """``_pair_halo_elems`` (pallas_halo.py:274-289) priced as
    ``plan_blocks`` prices it: streamed elements twice (the pipeline's
    two buffers) plus the held window, times X and the item size."""
    N = steps
    ein = bz * by + 4 * N * by + 4 * bz * esub + 12 * N * esub
    eout = bz * by
    held = (bz + 2 * N) * (by + 2 * N) + (bz + 2 * N - 2) * (by + 2 * N - 2)
    return itemsize * X * (2 * (ein + eout) + held)


def pair_halo_refusal(Z: int, Y: int, X: int, itemsize: int,
                      steps: int) -> Optional[str]:
    """Why the JAX planner finds no legal blocking for the N-step halo
    kernel on a (Z, Y, X) shard, or None when it finds one: a divisor
    ``bz`` of Z with ``max(2, N) <= bz <= min(max(16, N), Z)``, a divisor
    ``by`` of Y that is a multiple of the sublane tile with ``by <=
    min(128, Y)``, and a footprint within the budget."""
    esub = max(8, 32 // max(itemsize, 1))
    min_z = max(2, int(steps))
    cz = min(max(CAP_Z, min_z), Z)
    cy = min(max(CAP_Y, esub), Y)
    bzs = [d for d in range(1, Z + 1) if Z % d == 0 and min_z <= d <= cz]
    bys = [d for d in range(1, Y + 1)
           if Y % d == 0 and d % esub == 0 and d <= cy]
    if not bzs or not bys:
        return (f"no block_z in [{min_z}, {cz}] divides Z={Z}" if not bzs
                else f"no block_y <= {cy} that is a multiple of {esub} "
                     f"divides Y={Y}")
    cheapest = min(_pair_footprint(bz, by, X, itemsize, esub, steps)
                   for bz in bzs for by in bys)
    if cheapest > TILE_SELECT_BUDGET_BYTES:
        return (f"the smallest aligned block stages {cheapest} B against "
                f"the {TILE_SELECT_BUDGET_BYTES} B budget")
    return None
