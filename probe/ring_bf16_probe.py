#!/usr/bin/env python3
"""The Jacobi ring kernel's build on one CUDA card, for one checkout:
registers, spills and static SASS opcode counts of every ring
instantiation (K2's in ``jacobi7``, B6's in ``jacobi_halo``, float32 and
bfloat16), and the card's blocks an SM against the planner's
(``ring_tile``) at N = 1..8 for 4- and 2-byte cells.

    python3 probe/ring_bf16_probe.py [--root DIR] [--label NAME]

``--root DIR`` imports ``stencil_tpu_torch`` (and builds its kernels)
from DIR, say a parent commit unpacked with ``git archive`` into a
git-ignored directory; the reading of registers and SASS is this
checkout's ``chip_smoke.py`` (``ptxas_usage``, ``sass_counts``), loaded
by path. Writes ``chiprun_out/ring_probe_<label>.json`` and prints it as
the last line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

TREE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(TREE))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  TREE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("ring_bf16_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from stencil_tpu_torch.ops import _build
    from stencil_tpu_torch.ops import cuda_stencil as cs

    _build.build_all()
    ring = {str(k): v for k, v in smoke.ptxas_usage().items()
            if "jacobi_ring" in k}
    for k, counts in smoke.sass_counts().items():
        if "jacobi_ring" in k:
            ring.setdefault(str(k), {})["sass"] = counts
    dev = torch.device("cuda")
    occ = {}
    for item in (4, 2):
        for steps in range(1, 9):
            ty, depth, bps = cs.ring_tile(steps, item)
            card = cs.ring_occupancy(dev, steps, ty, depth, item)
            occ[f"itemsize {item} N = {steps}"] = dict(
                ty=ty, depth=depth, planned=bps, card=card)
    res = {"label": args.label, "root": args.root,
           "card": smoke.card_line(), "ring": ring, "occupancy": occ}
    for k, v in ring.items():
        print(f"{args.label}: {k}: {v}", flush=True)
    for k, v in occ.items():
        print(f"{args.label}: {k}: {v}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out",
                           f"ring_probe_{args.label}.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(res["card"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
