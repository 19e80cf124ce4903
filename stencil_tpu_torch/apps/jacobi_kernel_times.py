#!/usr/bin/env python3
"""Time K1, K2, B5 and B6 of one checkout of the port on one CUDA card,
so that two checkouts can be compared in turns in one call.

    python3 stencil_tpu_torch/apps/jacobi_kernel_times.py [--root DIR]
        [--label NAME] [--paths]

``--root DIR`` imports ``stencil_tpu_torch`` from DIR (default: this
checkout), say a parent commit unpacked with ``git archive`` into a
git-ignored directory. Run it once a checkout, each in a process of its
own, in turns (parent, this, this, parent). The measuring is this
checkout's, loaded by path, so that both are measured alike: the timing,
bounds and path rates of ``chip_smoke.py`` and the reading of registers
and spills of ``ops/_build.py``.

Cases, float32, N = 2 steps a launch for K2 and B6 (the main path's
group): K2 on a periodic 512^3 field and on (Z, Y, X) = (256, 256, 512);
B6 on 512^3 as one shard with its own wrapped slabs (the ``halo`` path
on one card) and on a 512 x 256 x 256 (x y z) grid as one shard (the
shape of a quarter shard of 512^3 over (1,2,2)); K1 and B5 at 512^3.
Each case is ``chip_smoke.event_ms`` of 20 launches after 3 warm-ups,
once forward and once backward through the cases, the two averaged.
``--paths`` adds the Jacobi path rates at 512^3 (``chip_smoke.timed_runs``
of three ``run(40)``): ``wrap``, ``halo`` on (1,1,1) and on four shards
of (1,2,2) on the card, ``overlap`` on (1,2,2). Writes one JSON object
to ``chiprun_out/jacobi_kernel_times_<label>.json`` and prints it as
the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
N = 2
REPS = 20
PATHS = (("wrap", "wrap", (1, 1, 1), {}),
         ("halo (1,1,1)", "halo", (1, 1, 1), {}),
         ("halo (1,2,2)", "halo", (1, 2, 2), {}),
         ("overlap (1,2,2)", "halo", (1, 2, 2), dict(overlap=True)))


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(TREE))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    smoke = _load("chip_smoke", TREE / "chip_smoke.py")
    ptxas_usage = _load("measuring_build", TREE / "stencil_tpu_torch" / "ops"
                        / "_build.py").ptxas_usage

    import torch

    if not torch.cuda.is_available():
        print("jacobi_kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    from stencil_tpu_torch.ops import _build
    from stencil_tpu_torch.ops import cuda_halo as ch
    from stencil_tpu_torch.ops import cuda_stencil as cs

    card = smoke.card_line()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _build.build_all(["jacobi7", "jacobi_halo"])
    gen = torch.Generator(device="cuda").manual_seed(97)
    n = 512

    def wrap(shape, steps):
        a = torch.rand(shape, generator=gen, device="cuda")
        b = torch.empty_like(a)
        hot, cold, r = smoke.spheres(shape)
        if steps == 1:
            fn = lambda: cs.jacobi7_wrap_cuda(a, hot, cold, r, out=b)
        else:
            fn = lambda: cs.jacobi7_wrapn_cuda(a, hot, cold, r, steps=steps,
                                               out=b)
        return fn, 8.0 * a.numel(), 7.0 * steps * a.numel()

    def halo(size_xyz, steps):
        kw = (dict(rz=1, ry=1) if steps == 1 else
              dict(rz=steps, ry=steps, radius_rows=steps, y_z_extended=True))
        (a,), (sl,), (org,), (lens,), (hot, cold, r), gsize = \
            smoke.halo_case(torch, gen, size_xyz, (1, 1, 1), kw)
        b = torch.empty_like(a)
        if steps == 1:
            fn = lambda: ch.jacobi7_halo_cuda(a, sl, org, hot, cold, r,
                                              interior_len_zy=lens, out=b)
        else:
            fn = lambda: ch.jacobi7_halon_cuda(a, sl, org, gsize, hot, cold,
                                               r, steps=steps, out=b)
        return (fn, smoke.halo_bytes(a.shape, steps, steps > 1),
                7.0 * steps * a.numel())

    cases = {"K2 512^3": wrap((n, n, n), N),
             "B6 512^3 (1,1,1)": halo((n, n, n), N),
             "K2 256x256x512": wrap((n // 2, n // 2, n), N),
             "B6 512x256x256 shard": halo((n, n // 2, n // 2), N),
             "K1 512^3": wrap((n, n, n), 1),
             "B5 512^3 (1,1,1)": halo((n, n, n), 1)}
    turns = {k: [] for k in cases}
    for name in list(cases) + list(reversed(cases)):
        turns[name].append(smoke.event_ms(torch, cases[name][0], REPS,
                                          warmup=3))
    res = {"label": args.label, "card": card, "root": args.root,
           "steps": N, "reps": REPS, "cases": {}, "ptxas": {
               name: use for (_, name), use
               in ptxas_usage(log.getvalue()).items()
               if any(k in name for k in ("wrapn", "halon", "jacobi_ring"))}}
    for name, (_, nbytes, flops) in cases.items():
        ms = sum(turns[name]) / len(turns[name])
        bound, by = smoke.bound_ms(nbytes, flops)
        res["cases"][name] = {"ms": ms, "turns_ms": turns[name],
                              "bound_ms": bound, "bound_by": by,
                              "share": bound / ms}
        print(f"{args.label}: {name}: {ms!r} ms ({turns[name]}), bound "
              f"{bound!r} ms ({by}), {100 * bound / ms:.1f}% of bound",
              flush=True)
    del cases
    torch.cuda.empty_cache()
    if args.paths:
        res["paths"] = {}
        for name, kernel, mesh, kw in PATHS:
            j = smoke.jacobi_mesh(kernel, mesh, **kw)
            j.run(2)
            j.block()
            rate, runs = smoke.timed_runs(j, 40)
            res["paths"][name] = [rate, runs]
            print(f"{args.label}: path {name}: {rate!r} steps/s ({runs})",
                  flush=True)
            del j
            torch.cuda.empty_cache()
    for name, use in res["ptxas"].items():
        print(f"{args.label}: ptxas {name}: {use}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out",
                        f"jacobi_kernel_times_{args.label}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
