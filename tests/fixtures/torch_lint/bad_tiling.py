"""Negative controls for the tiling checker: K2's plan at 256^3 whose z
tiles skip every other run (cells no block writes), and B8's plan held
to a verdict pinned at another z run."""

import dataclasses

from stencil_tpu_torch.analysis.tiling import (TilingTarget, b8_plan, grid,
                                               k2_plan)


def _gap():
    p = k2_plan(256, 2)
    step = p.tiles[0][0][1] - p.tiles[0][0][0]
    z = tuple((s, e) for s, e in grid(0, 256, 2 * step))
    z = tuple((s, min(s + step, e)) for s, e in z)
    return dataclasses.replace(p, tiles=(z,) + p.tiles[1:])


TARGETS = [TilingTarget("fixture.tiling.tiles_leave_a_gap", _gap),
           TilingTarget("fixture.tiling.verdict_changed",
                        lambda: b8_plan(256), (69120, 2, 16))]
