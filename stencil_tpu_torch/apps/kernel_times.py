#!/usr/bin/env python3
"""Time the kernels of one checkout of the port on one CUDA card, so
that two checkouts can be compared in turns in one call.

    python3 stencil_tpu_torch/apps/kernel_times.py
        [--model jacobi|mhd|pair|laplace6|exchange] [--root DIR]
        [--label NAME] [--paths] [--baseline] [--plans] [--bf16]

``--root DIR`` imports ``stencil_tpu_torch`` from DIR (default: this
checkout), say a parent commit unpacked with ``git archive`` into a
git-ignored directory. Run it once a checkout, each in a process of its
own, in turns (parent, this, this, parent). The measuring is this
checkout's, loaded by path, so that both are measured alike: the timing,
bounds and path rates of ``chip_smoke.py``, the reading of registers and
spills of ``ops/_build.py`` and the kernel profile of
``utils/timers.py``. Each case is timed once forward and once backward
through the cases, the two averaged.

``--model jacobi`` (the default): float32, N = 2 steps a launch for K2
and B6 (the main path's group): K2 on a periodic 512^3 field and on
(Z, Y, X) = (256, 256, 512); B6 on 512^3 as one shard with its own
wrapped slabs (the ``halo`` path on one card) and on a 512 x 256 x 256
(x y z) grid as one shard (a quarter shard of 512^3 over (1,2,2)); K1
and B5 at 512^3; each ``chip_smoke.event_ms`` of 20 launches after 3
warm-ups. ``--paths`` adds the Jacobi path rates at 512^3
(``chip_smoke.timed_runs`` of three ``run(40)``): ``wrap``, ``halo`` on
(1,1,1) and on four shards of (1,2,2) on the card, ``overlap`` on
(1,2,2).

``--model mhd``: B14 (mhd_substep_fixup, the exterior shell of the MHD
overlap path) for each one-substep variant (s = 0 with w=None, s = 1,
s = 2 with write_w=False) on random 256^3 shards (sigma 0.1, w sigma
1e-4, from a seeded generator), after one B13, on one 256^3 shard (a
(1,1,1) mesh: its rows go to itself) and on the four 256^3 shards of
256 x 512 x 512 over (1,2,2): by CUDA events (host work included,
``chip_smoke.event_ms`` of 10 calls after 2 warm-ups), its device time
alone (``chip_smoke.device_ms``) and per kernel it launches
(``kernel_profile``); and B11 on the one shard (the per-point rate the
shell could reach). ``--baseline`` adds B14's z-streaming baseline on
the one shard: B11's ring kernel (``launch_ring`` of DIR's
``csrc/mhd_ring.cuh``, margin rows by B11's slab rule) over each of
``shell_regions``' four strips, all walking z, from a small source built
against DIR's headers, held bitwise against B14 first. ``--paths`` adds
the Astaroth ``halo-overlap`` and ``halo`` rates on 256 x 512 x 512 over
(1,2,2), four shards on the card (three ``run(10)``).

``--model pair``: the substep pair B10 (mhd_substep01_wrap) and B12
(mhd_substep01_halo) beside the one-substep kernels they are made of,
on one 256^3 shard (shard 0 of four random 256^3 shards of 256 x 512 x
512 over (1,2,2), sigma 0.1, w sigma 1e-4, from a seeded generator):
B9 for each variant and B10 on its fields as a periodic field; B11 for
each variant on its slabs of R rows and B12 on its slabs of 2R rows;
B13 for each variant on the shard as a (1,1,1) mesh (its sends and its
interior, which the ring kernel computes); the pair forms of B13 and
B14 on that mesh (B14's pair after a B13 pair on the same fields).
Each by CUDA events, by its device time alone and per kernel it
launches, as ``--model mhd`` times B14. ``--paths`` adds the Astaroth
rates of ``wrap`` and ``wrap`` + pair at 256^3, of ``halo``, ``halo`` +
pair, ``halo-overlap`` and ``halo-overlap`` + pair on 256 x 512 x 512
over (1,2,2), four shards on the card, and of ``halo-overlap`` with and
without the pair on 256^3 over (1,1,1) (three ``run(10)`` each).

``--bf16`` (``--model mhd`` and ``pair``): the same with bfloat16
fields (stored half-width, computed in float32; the pairs' scratch
float32), the bounds counting 2-byte cells, the paths in bfloat16; the
results go to ``kernel_times_<model>_bf16_<label>.json``. With ``--model
jacobi``: K1, K2, K3, B5 and B6 in bfloat16 (computed in bfloat16, as
the JAX kernels compute), K2 and B6 also at N = 16 (two launches), K3
beside ``conv3d``'s bfloat16 time, the paths in bfloat16.

``--model laplace6``: B8 (laplace6, no model path runs it) on a random
256^3 interior padded by 3 (Astaroth's per-rank grid) and on 136 x 128
x 96 (Z, Y, X), where B8's tiles and z runs are ragged, each first held
bitwise to its twin, and a plain ``copy_`` of the 256^3 padded field
(the practical ceiling): each ``chip_smoke.event_ms`` of 20 launches
after 3 warm-ups and by device time alone (``chip_smoke.device_ms``),
with B8's launch plan and, where the tree has them, the card's blocks
an SM (``laplace6_plan``, ``laplace6_occupancy``). ``--plans`` (a tree
with ``laplace6_plan``) adds, at both shapes by device time in turns,
B8 launched with other z runs than its plan's and with its 4-byte
copies (the field one float past 8 bytes).

``--model exchange``: the halo exchange engine, no kernel: the
milliseconds of one ``DistributedDomain.exchange()`` of the
``bench_exchange`` configuration (four 256^3 float32 shards of (2,2,1)
on the card, face, edge and corner radius 2) at exchange depths 1, 2
and 4, and, where the tree has wire layouts, of the irredundant layout
at depth 1 (``chip_smoke.event_ms`` of 30 exchanges after 3 warm-ups,
host work included). ``--paths`` adds the Jacobi ``xla`` and ``pallas``
rates on four 512 x 256 x 256 shards of (1,2,2) on the card
(``chip_smoke.timed_runs`` of three ``run(20)`` / ``run(40)``), and,
where the tree has wire formats, the same behind f32 irredundant and
bf16 irredundant wires.

Writes one JSON object to
``chiprun_out/kernel_times_<model>_<label>.json`` and prints it as the
last line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
JACOBI_PATHS = (("wrap", "wrap", (1, 1, 1), {}),
                ("halo (1,1,1)", "halo", (1, 1, 1), {}),
                ("halo (1,2,2)", "halo", (1, 2, 2), {}),
                ("overlap (1,2,2)", "halo", (1, 2, 2), dict(overlap=True)))
MHD_VARIANTS = ((0, False, True), (1, True, True), (2, True, False))

# B14's z-streaming baseline (--baseline): B11's ring kernel over each
# strip of the shell (regions: z0, nz, y0, ny, zrun per strip)
BASELINE_SRC = r"""
#include "mhd_common.cuh"
#include "mhd_ring.cuh"

#include <cstring>

extern "C" cudaError_t b14_zstream_launch(
    const void* const* fields, const void* const* w, const void* const* slabs,
    void* const* out_f, void* const* out_w, const int* regions, int n, int Z,
    int Y, int X, int rz, int ry, const float* consts, void* stream) {
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  for (int k = 0; k < n; ++k) {
    const int* r = regions + 5 * k;
    const RingGeom g{{Z, Y, X, rz, ry}, r[0], r[1], r[2], r[3], r[4],
                     kHaloRows};
    const cudaError_t err = launch_ring(
        in_ptrs(fields), in_ptrs(w), slab_ptrs(slabs), out_ptrs(out_f),
        out_ptrs(out_w), g, c, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
"""


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Measuring:
    """This checkout's measuring modules, loaded by path."""

    def __init__(self):
        ops = TREE / "stencil_tpu_torch"
        self.smoke = _load("chip_smoke", TREE / "chip_smoke.py")
        self.build = _load("measuring_build", ops / "ops" / "_build.py")
        self.timers = _load("measuring_timers", ops / "utils" / "timers.py")


def time_in_turns(cases: dict, timers: dict) -> dict:
    """{case: {timer: [forward, backward]}}: every timer of ``timers``
    (name -> fn(case's callable) -> ms) on every case, once forward and
    once backward through the cases."""
    got = {k: {t: [] for t in timers} for k in cases}
    for name in list(cases) + list(reversed(cases)):
        for t, timer in timers.items():
            got[name][t].append(timer(cases[name][0]))
    return got


def jacobi(args, m: Measuring, log: io.StringIO) -> dict:
    import torch

    from stencil_tpu_torch.ops import _build
    from stencil_tpu_torch.ops import cuda_halo as ch
    from stencil_tpu_torch.ops import cuda_stencil as cs

    smoke, steps, reps = m.smoke, 2, 20
    dtype, item = _storage(args)
    with contextlib.redirect_stdout(log):
        _build.build_all(["jacobi7", "jacobi_halo"])
    gen = torch.Generator(device="cuda").manual_seed(97)
    n = 512

    def wrap(shape, k):
        a = torch.rand(shape, generator=gen, device="cuda").to(dtype)
        b = torch.empty_like(a)
        hot, cold, r = smoke.spheres(shape)
        if k == 1:
            fn = lambda: cs.jacobi7_wrap_cuda(a, hot, cold, r, out=b)
        else:
            fn = lambda: cs.jacobi7_wrapn_cuda(a, hot, cold, r, steps=k,
                                               out=b)
        return fn, 2.0 * item * a.numel(), 7.0 * k * a.numel()

    def padded(shape):
        from stencil_tpu_torch.geometry import Dim3, Radius

        p = torch.rand(tuple(v + 2 for v in shape), generator=gen,
                       device="cuda").to(dtype)
        b = torch.empty(shape, dtype=dtype, device="cuda")
        inner = Dim3(shape[2], shape[1], shape[0])
        fn = lambda: cs.jacobi7_padded_cuda(p, Radius.constant(1), inner,
                                            out=b)
        return fn, item * (p.numel() + b.numel()), 6.0 * b.numel()

    def halo(size_xyz, k):
        kw = (dict(rz=1, ry=1) if k == 1 else
              dict(rz=k, ry=k, radius_rows=k, y_z_extended=True))
        (a,), (sl,), (org,), (lens,), (hot, cold, r), gsize = \
            smoke.halo_case(torch, gen, size_xyz, (1, 1, 1), kw,
                            dtype=dtype)
        b = torch.empty_like(a)
        if k == 1:
            fn = lambda: ch.jacobi7_halo_cuda(a, sl, org, hot, cold, r,
                                              interior_len_zy=lens, out=b)
        else:
            fn = lambda: ch.jacobi7_halon_cuda(a, sl, org, gsize, hot, cold,
                                               r, steps=k, out=b)
        return (fn, smoke.halo_bytes(a.shape, k, k > 1, item),
                7.0 * k * a.numel())

    cases = {"K2 512^3": wrap((n, n, n), steps),
             "B6 512^3 (1,1,1)": halo((n, n, n), steps),
             "K2 256x256x512": wrap((n // 2, n // 2, n), steps),
             "B6 512x256x256 shard": halo((n, n // 2, n // 2), steps),
             "K1 512^3": wrap((n, n, n), 1),
             "B5 512^3 (1,1,1)": halo((n, n, n), 1)}
    if args.bf16:
        cases.update({"K2 512^3 N=16": wrap((n, n, n), 16),
                      "B6 512^3 (1,1,1) N=16": halo((n, n, n), 16),
                      "K3 512^3": padded((n, n, n))})
    turns = time_in_turns(cases, {"ms": lambda fn: smoke.event_ms(
        torch, fn, reps, warmup=3)})
    res = {"steps": steps, "reps": reps, "cases": {}}
    for name, (_, nbytes, flops) in cases.items():
        ms = sum(turns[name]["ms"]) / 2
        bound, by = smoke.bound_ms(nbytes, flops)
        res["cases"][name] = {"ms": ms, "turns_ms": turns[name]["ms"],
                              "bound_ms": bound, "bound_by": by,
                              "share": bound / ms}
        print(f"{args.label}: {name}: {ms!r} ms ({turns[name]['ms']}), "
              f"bound {bound!r} ms ({by}), {100 * bound / ms:.1f}% of bound",
              flush=True)
    del cases
    torch.cuda.empty_cache()
    if args.paths:
        res["paths"] = {}
        for name, kernel, mesh, kw in JACOBI_PATHS:
            j = smoke.jacobi_mesh(kernel, mesh, dtype=dtype, **kw)
            j.run(2)
            j.block()
            rate, runs = smoke.timed_runs(j, 40)
            res["paths"][name] = [rate, runs]
            print(f"{args.label}: path {name}: {rate!r} steps/s ({runs})",
                  flush=True)
            del j
            torch.cuda.empty_cache()
    res["ptxas"] = {name: use for (_, name), use
                    in m.build.ptxas_usage(log.getvalue()).items()
                    if any(k in name for k in ("wrapn", "halon",
                                               "jacobi_ring"))}
    return res


def build_baseline(root: Path, flags, log: io.StringIO):
    """The baseline's launcher, built against ``root``'s kernel headers
    with the measuring nvcc flags into ``root``'s build directory."""
    from stencil_tpu_torch.ops import _build

    out = _build.BUILD_DIR
    out.mkdir(parents=True, exist_ok=True)
    src = out / "b14_zstream.cu"
    src.write_text(BASELINE_SRC)
    lib = out / "libb14_zstream.so"
    got = subprocess.run([_build.find_nvcc(), *flags, "-I",
                          str(_build.SRC_DIR), "-o", str(lib), str(src)],
                         capture_output=True, text=True, timeout=600)
    log.write(f"nvcc b14_zstream.cu:\n{got.stdout}{got.stderr}")
    if got.returncode != 0:
        raise RuntimeError(f"the baseline did not build:\n{got.stderr}")
    fn = ctypes.CDLL(str(lib)).b14_zstream_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 6 + [I] * 6 + [P, P]
    fn.restype = I
    return fn


def _storage(args):
    """(torch dtype, bytes a cell) of the MHD fields: float32, or with
    ``--bf16`` bfloat16."""
    import torch

    return ((torch.bfloat16, 2) if args.bf16 else (torch.float32, 4))


def _tag(s: int, read_w: bool, write_w: bool) -> str:
    return (f"s={s}{'' if read_w else ' (w=None)'}"
            f"{'' if write_w else ' (write_w=False)'}")


def mhd(args, m: Measuring, log: io.StringIO) -> dict:
    import numpy as np
    import torch

    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams
    from stencil_tpu_torch.ops import _build
    from stencil_tpu_torch.ops import cuda_mhd as cm
    from stencil_tpu_torch.ops import cuda_mhd_overlap as mo

    smoke, reps, n = m.smoke, 10, 256
    dtype, item = _storage(args)
    with contextlib.redirect_stdout(log):
        _build.build_all(["mhd", "mhd_overlap"])
    gen = torch.Generator(device="cuda").manual_seed(24680)
    prm = MhdParams()
    dt = prm.dt
    shape = (n, n, n)
    p_sh = n ** 3 - (n - 2 * cm.R) ** 2 * n   # the one-substep shell
    cases, meshes = {}, {}
    for where, mesh, size in (("one 256^3 shard", (1, 1, 1), shape),
                              ("four 256^3 shards of (1,2,2)", (1, 2, 2),
                               (2 * n, 2 * n, n))):
        counts = Dim3(*mesh)
        shards, ws = smoke.mhd_mesh_case(torch, gen, size, mesh)
        shards = [t.to(dtype) for t in shards]
        ws = [t.to(dtype) for t in ws]
        f = [smoke.per_field(t) for t in shards]
        w = [smoke.per_field(t) for t in ws]
        of = [smoke.per_field(torch.empty_like(t)) for t in shards]
        ow = [smoke.per_field(torch.empty_like(t)) for t in shards]
        recv = mo.MhdOverlapRecv(shards, counts)
        meshes[where] = (shards, ws, recv)
        for s, read_w, write_w in MHD_VARIANTS:
            w_in = w if read_w else None
            w_out = ow if write_w else None

            def b14(f=f, w_in=w_in, of=of, w_out=w_out, s=s, counts=counts,
                    recv=recv):
                mo.mhd_substep_fixup_cuda(f, w_in, of, w_out, s, prm, dt,
                                          counts, recv)

            per = len(shards)
            cases[f"B14 {_tag(s, read_w, write_w)}, {where}"] = (
                b14, per * smoke.b14_bytes(shape, read_w, write_w, False,
                                           item=item),
                per * smoke.B9_FLOPS[s] * p_sh)

    # B11 (and the baseline) on the one shard
    shards, ws, recv = meshes["one 256^3 shard"]
    f, w = smoke.per_field(shards[0]), smoke.per_field(ws[0])
    landed = recv.landed(cm.R)[0]
    slab = 8 * item * (2 * cm.R * n * n + 2 * (n + 2 * cm.R) * cm.R * n)
    res = {"reps": reps, "cases": {}, "checks": {}}
    if args.baseline:
        launch = build_baseline(Path(args.root).resolve(),
                                m.build.NVCC_FLAGS, log)
        n_sms = cm.sm_count(torch.device("cuda"))
        regions = np.asarray(
            [[z0, nz, y0, ny, cm.ring_zrun(nz, ny, n, n_sms)]
             for z0, nz, y0, ny in mo.shell_regions(n, n, False)],
            dtype=np.int32)
        res["baseline_regions"] = regions.tolist()
        p_in = cm._ptrs([f[q] for q in FIELDS])
        p_sl = cm._ptrs(cm._slab_list(landed))
    for s, read_w, write_w in MHD_VARIANTS:
        tag = _tag(s, read_w, write_w)
        w_in = w if read_w else None
        wr = (8 if read_w else 0) + (8 if write_w else 0)

        def b11(w_in=w_in, s=s, write_w=write_w):
            cm.mhd_substep_halo_cuda(f, w_in, landed, s, prm, dt,
                                     write_w=write_w)

        cases[f"B11 {tag}, one 256^3 shard"] = (
            b11, item * (16 + wr) * n ** 3 + slab, smoke.B9_FLOPS[s] * n ** 3)
        if not args.baseline:
            continue
        out_f = smoke.per_field(torch.empty_like(shards[0]))
        out_w = smoke.per_field(torch.empty_like(shards[0]))
        consts = cm.kernel_consts(prm, dt, s)
        ptrs = (cm._ptrs([w[q] for q in FIELDS]) if read_w else None,
                cm._ptrs([out_f[q] for q in FIELDS]),
                cm._ptrs([out_w[q] for q in FIELDS]) if write_w else None)

        def base(ptrs=ptrs, consts=consts):
            p_w, p_f, p_wo = ptrs
            err = launch(p_in, p_w, p_sl, p_f, p_wo, regions.ctypes.data,
                         len(regions), n, n, n, cm.R, cm.R,
                         consts.ctypes.data,
                         torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"b14_zstream_launch: CUDA error {err}")

        # the baseline's shell equals B14's after B13, bit for bit
        ws_in = None if w_in is None else [w_in]
        mo.mhd_substep_overlap_cuda([f], ws_in, s, prm, dt, Dim3(1, 1, 1),
                                    write_w=write_w, out_f=[out_f],
                                    out_w=[out_w] if write_w else None,
                                    recv=recv)
        want = ({q: t.clone() for q, t in out_f.items()},
                {q: t.clone() for q, t in out_w.items()})
        mo.mhd_substep_fixup_cuda([f], ws_in, [want[0]],
                                  [want[1]] if write_w else None, s, prm, dt,
                                  Dim3(1, 1, 1), recv)
        base()
        torch.cuda.synchronize()
        same = all(torch.equal(out_f[q], want[0][q]) for q in FIELDS) and (
            not write_w or all(torch.equal(out_w[q], want[1][q])
                               for q in FIELDS))
        res["checks"][f"baseline {tag} vs B14 after B13"] = same
        print(f"{args.label}: z-streaming baseline {tag} vs B14 after B13: "
              f"{'bitwise equal' if same else 'DIFFERENT'}", flush=True)
        if not same:
            raise AssertionError(f"the baseline differs from B14 ({tag})")
        del want
        cases[f"z-streaming baseline {tag}, one 256^3 shard"] = (
            base, smoke.b14_bytes(shape, read_w, write_w, False),
            smoke.B9_FLOPS[s] * p_sh)

    turns = time_in_turns(cases, {
        "events": lambda fn: smoke.event_ms(torch, fn, reps),
        "device": lambda fn: smoke.device_ms(torch, fn, reps)})
    for name, (fn, nbytes, flops) in cases.items():
        ms = sum(turns[name]["events"]) / 2
        dev_ms = sum(turns[name]["device"]) / 2
        bound, by = smoke.bound_ms(nbytes, flops)
        split = m.timers.kernel_profile(fn, 5)[0]
        res["cases"][name] = {
            "ms": ms, "turns_ms": turns[name]["events"], "device_ms": dev_ms,
            "turns_device_ms": turns[name]["device"], "bound_ms": bound,
            "bound_by": by, "share_device": bound / dev_ms, "split": split}
        print(f"{args.label}: {name}: {ms!r} ms by events "
              f"({turns[name]['events']}), device alone {dev_ms!r} ms "
              f"({turns[name]['device']}), bound {bound!r} ms ({by}), "
              f"{100 * bound / dev_ms:.1f}% of bound on the device; kernels "
              f"{ {k: round(v['us'], 2) for k, v in split.items()} } us, "
              f"launches { {k: v['launches'] for k, v in split.items()} }",
              flush=True)
    del cases, meshes, shards, ws, recv
    torch.cuda.empty_cache()
    if args.paths:
        res["paths"] = {}
        for label, overlap in (("halo-overlap", True), ("halo", False)):
            a = Astaroth(n, 2 * n, 2 * n, kernel="halo", overlap=overlap,
                         mesh_shape=(1, 2, 2), devices=["cuda:0"] * 4,
                         dtype=dtype)
            a.init()
            a.run(1)
            a.block()
            rate, runs = smoke.timed_runs(a, 10)
            res["paths"][f"{label} 256x512x512 (1,2,2)"] = [rate, runs]
            print(f"{args.label}: path {label} 256x512x512 (1,2,2): {rate!r} "
                  f"iterations/s ({runs})", flush=True)
            del a
            torch.cuda.empty_cache()
    res["ptxas"] = {name: use for (lib, name), use
                    in m.build.ptxas_usage(log.getvalue()).items()
                    if lib in ("mhd_overlap", "b14_zstream")}
    return res


def pair(args, m: Measuring, log: io.StringIO) -> dict:
    import torch

    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.models.astaroth import Astaroth, MhdParams
    from stencil_tpu_torch.ops import _build
    from stencil_tpu_torch.ops import cuda_mhd as cm
    from stencil_tpu_torch.ops import cuda_mhd_overlap as mo

    smoke, reps, n = m.smoke, 10, 256
    dtype, item = _storage(args)
    with contextlib.redirect_stdout(log):
        _build.build_all(["mhd", "mhd_overlap"])
    gen = torch.Generator(device="cuda").manual_seed(13579)
    shards, ws = smoke.mhd_mesh_case(torch, gen, (2 * n, 2 * n, n),
                                     (1, 2, 2))
    shards = [t.to(dtype) for t in shards]
    ws = [t.to(dtype) for t in ws]
    f, w = smoke.per_field(shards[0]), smoke.per_field(ws[0])
    sl3 = smoke.mhd_slabs(shards, (1, 2, 2), rz=cm.R, ry=cm.R)[0]
    sl6 = smoke.mhd_slabs(shards, (1, 2, 2), rz=2 * cm.R, ry=2 * cm.R)[0]
    del shards[1:], ws[1:]
    prm = MhdParams()
    dt = prm.dt
    pts = float(n ** 3)
    field = item * pts
    one = Dim3(1, 1, 1)
    recv = mo.MhdOverlapRecv([shards[0]], one)
    of = [smoke.per_field(torch.empty_like(shards[0]))]
    ow = [smoke.per_field(torch.empty_like(shards[0]))]
    inner = (n - 2 * cm.R) ** 2 * n
    shape = (n, n, n)

    def slab_bytes(r):       # the slab rows a kernel reads, 8 fields
        return 8 * item * (2 * r * n * n + 2 * (n + 2 * r) * r * n)

    cases = {}
    for s, read_w, write_w in MHD_VARIANTS:
        tag = _tag(s, read_w, write_w)
        w_in = w if read_w else None
        wr = (8 if read_w else 0) + (8 if write_w else 0)
        flops = smoke.B9_FLOPS[s] * pts

        def b9(w_in=w_in, s=s, write_w=write_w):
            cm.mhd_substep_wrap_cuda(f, w_in, s, prm, dt, write_w=write_w)

        def b11(w_in=w_in, s=s, write_w=write_w):
            cm.mhd_substep_halo_cuda(f, w_in, sl3, s, prm, dt,
                                     write_w=write_w)

        def b13(w_in=w_in, s=s, write_w=write_w):
            mo.mhd_substep_overlap_cuda(
                [f], None if w_in is None else [w_in], s, prm, dt, one,
                write_w=write_w, out_f=of, out_w=ow if write_w else None,
                recv=recv)

        cases[f"B9 {tag}"] = (b9, (8 + 8 + wr) * field, flops)
        cases[f"B11 {tag}"] = (b11, (8 + 8 + wr) * field + slab_bytes(cm.R),
                               flops)
        cases[f"B13 {tag}"] = (b13, item * (8 * pts + (8 + wr) * inner)
                               + slab_bytes(cm.R),
                               smoke.B9_FLOPS[s] * inner)
    cases["B10"] = (lambda: cm.mhd_substep01_wrap_cuda(f, prm, dt),
                    24 * field, smoke.B10_FLOPS * pts)
    cases["B12"] = (lambda: cm.mhd_substep01_halo_cuda(f, sl6, prm, dt),
                    24 * field + slab_bytes(2 * cm.R),
                    smoke.B10_FLOPS * pts)

    # the pair forms of B13 and B14 on the shard as a (1,1,1) mesh; B14's
    # pair completes what the last B13 pair on the same fields left
    def b13_pair():
        mo.mhd_substep_overlap_cuda([f], None, 0, prm, dt, one, pair=True,
                                    out_f=of, out_w=ow, recv=recv)

    def b14_pair():
        mo.mhd_substep_fixup_cuda([f], None, of, ow, 0, prm, dt, one, recv,
                                  pair=True)

    b13_pair()
    z0, nz, y0, ny = mo.interior_region(n, n, True)
    inner2 = float(nz * ny * n)
    cases["B13 pair"] = (b13_pair, smoke.b13_bytes(shape, False, True, True,
                                                   item=item),
                         smoke.B10_FLOPS * inner2)
    cases["B14 pair"] = (b14_pair, smoke.b14_bytes(shape, False, True, True,
                                                   item=item),
                         smoke.B10_FLOPS * (pts - inner2))
    turns = time_in_turns(cases, {
        "events": lambda fn: smoke.event_ms(torch, fn, reps),
        "device": lambda fn: smoke.device_ms(torch, fn, reps)})
    res = {"reps": reps, "cases": {}}
    for name, (fn, nbytes, flops) in cases.items():
        ms = sum(turns[name]["events"]) / 2
        dev_ms = sum(turns[name]["device"]) / 2
        bound, by = smoke.bound_ms(nbytes, flops)
        split = m.timers.kernel_profile(fn, 3)[0]
        res["cases"][name] = {
            "ms": ms, "turns_ms": turns[name]["events"], "device_ms": dev_ms,
            "turns_device_ms": turns[name]["device"], "bound_ms": bound,
            "bound_by": by, "share_device": bound / dev_ms, "split": split}
        print(f"{args.label}: {name}, one 256^3 shard: {ms!r} ms by events "
              f"({turns[name]['events']}), device alone {dev_ms!r} ms "
              f"({turns[name]['device']}), bound {bound!r} ms ({by}), "
              f"{100 * bound / dev_ms:.1f}% of bound on the device; kernels "
              f"{ {k: round(v['us'], 2) for k, v in split.items()} } us, "
              f"launches { {k: v['launches'] for k, v in split.items()} }",
              flush=True)
    del cases, shards, ws, f, w, sl3, sl6, recv, of, ow
    torch.cuda.empty_cache()
    if args.paths:
        res["paths"] = {}
        big = (n, 2 * n, 2 * n)
        cube = (n,) * 3
        for label, size, mesh, kernel, on, overlap in (
                ("wrap 256^3", cube, (1, 1, 1), "wrap", "0", False),
                ("wrap+pair 256^3", cube, (1, 1, 1), "wrap", "1", False),
                ("halo 256x512x512 (1,2,2)", big, (1, 2, 2), "halo", "0",
                 False),
                ("halo+pair 256x512x512 (1,2,2)", big, (1, 2, 2), "halo",
                 "1", False),
                ("halo-overlap 256x512x512 (1,2,2)", big, (1, 2, 2), "halo",
                 "0", True),
                ("halo-overlap+pair 256x512x512 (1,2,2)", big, (1, 2, 2),
                 "halo", "1", True),
                ("halo-overlap 256^3 (1,1,1)", cube, (1, 1, 1), "halo", "0",
                 True),
                ("halo-overlap+pair 256^3 (1,1,1)", cube, (1, 1, 1), "halo",
                 "1", True)):
            with smoke.mhd_pair(on):
                a = Astaroth(*size, kernel=kernel, overlap=overlap,
                             mesh_shape=mesh, dtype=dtype,
                             devices=["cuda:0"] * (mesh[1] * mesh[2]))
            a.init()
            a.run(1)
            a.block()
            rate, runs = smoke.timed_runs(a, 10)
            res["paths"][label] = [rate, runs]
            print(f"{args.label}: path {label}: {rate!r} iterations/s "
                  f"({runs})", flush=True)
            del a
            torch.cuda.empty_cache()
    res["ptxas"] = {name: use for (lib, name), use
                    in m.build.ptxas_usage(log.getvalue()).items()
                    if lib in ("mhd", "mhd_overlap")}
    return res


def laplace6(args, m: Measuring, log: io.StringIO) -> dict:
    import torch

    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.ops import _build
    from stencil_tpu_torch.ops import cuda_stencil as cs

    smoke, reps = m.smoke, 20
    with contextlib.redirect_stdout(log):
        _build.build_all(["laplace6"])
    gen = torch.Generator(device="cuda").manual_seed(2468)
    r3 = Radius.constant(3)
    inv = smoke.mhd_inv_ds()
    dev = torch.device("cuda")
    cases, res = {}, {"reps": reps, "cases": {}, "plans": {}}
    for label, (Z, Y, X) in (("B8 256^3", (256, 256, 256)),
                             ("B8 136x128x96", (136, 128, 96))):
        pad = torch.randn((Z + 6, Y + 6, X + 6), generator=gen, device=dev)
        out = torch.empty((Z, Y, X), device=dev)
        interior = Dim3(X, Y, Z)
        same = torch.equal(cs.laplace6_cuda(pad, r3, interior, inv, out=out),
                           cs.laplace6_plain(pad, r3, interior, inv))
        print(f"{args.label}: {label} vs its twin: "
              f"{'bitwise equal' if same else 'DIFFERENT'}", flush=True)
        if not same:
            raise AssertionError(f"{label}: kernel differs from its twin")
        cases[label] = (
            lambda pad=pad, interior=interior, out=out: cs.laplace6_cuda(
                pad, r3, interior, inv, out=out),
            4.0 * (pad.numel() + out.numel()),
            smoke.LAPLACE6_FLOPS * out.numel())
        if hasattr(cs, "laplace6_plan"):
            plan = cs.laplace6_plan(Z, Y, X, cs.sm_count(dev))
            res["plans"][label] = dict(
                plan._asdict(),
                card_blocks_per_sm=cs.laplace6_occupancy(dev))
    pad = torch.randn((262,) * 3, generator=gen, device=dev)
    dst = torch.empty_like(pad)
    cases["copy_ of the 256^3 padded field"] = (
        lambda: dst.copy_(pad), 8.0 * pad.numel(), 0.0)
    turns = time_in_turns(cases, {
        "events": lambda fn: smoke.event_ms(torch, fn, reps, warmup=3),
        "device": lambda fn: smoke.device_ms(torch, fn, reps, warmup=3)})
    for name, (_, nbytes, flops) in cases.items():
        ms = sum(turns[name]["events"]) / 2
        dev_ms = sum(turns[name]["device"]) / 2
        bound, by = smoke.bound_ms(nbytes, flops)
        res["cases"][name] = {
            "ms": ms, "turns_ms": turns[name]["events"], "device_ms": dev_ms,
            "turns_device_ms": turns[name]["device"], "bound_ms": bound,
            "bound_by": by, "share": bound / ms}
        print(f"{args.label}: {name}: {ms!r} ms by events "
              f"({turns[name]['events']}), device alone {dev_ms!r} ms "
              f"({turns[name]['device']}), bound {bound!r} ms ({by}), "
              f"{100 * bound / ms:.1f}% of bound", flush=True)
    for label, plan in res["plans"].items():
        print(f"{args.label}: {label} plan {plan}", flush=True)
    if args.plans and hasattr(cs, "laplace6_plan"):
        res["plan_sweep"] = {}
        for shape in LAPLACE6_SWEEPS:
            res["plan_sweep"].update(laplace6_plans(m, cs, shape))
    res["ptxas"] = {name: use for (lib, name), use
                    in m.build.ptxas_usage(log.getvalue()).items()
                    if lib == "laplace6"}
    return res


# B8's plan sweeps (--plans): (Z, Y, X) -> other z runs to try
LAPLACE6_SWEEPS = {(256, 256, 256): (26, 37, 43, 64),
                   (136, 128, 96): (7, 9, 12, 17)}


def laplace6_plans(m: Measuring, cs, shape) -> dict:
    """B8 on a (Z, Y, X) interior padded by 3 with ``laplace6_plan``'s
    z run and those of ``LAPLACE6_SWEEPS``, and with its 4-byte copies,
    by device time, forward and backward through the cases; each first
    held bitwise to the twin."""
    import numpy as np
    import torch

    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.ops import _build

    smoke, dev = m.smoke, torch.device("cuda")
    Z, Y, X = shape
    inv = smoke.mhd_inv_ds()
    ix2, iy2, iz2 = (float(np.float32(v * v)) for v in inv)
    gen = torch.Generator(device="cuda").manual_seed(1357)
    padded = (Z + 6, Y + 6, X + 6)
    numel = padded[0] * padded[1] * padded[2]
    buf = torch.randn((numel + 1,), generator=gen, device=dev)
    out = torch.empty(shape, device=dev)
    zrun = cs.laplace6_plan(Z, Y, X, cs.sm_count(dev)).zrun

    def launch(p, run):
        _build.launch("laplace6", "laplace6_launch",
                      cs._SIGNATURES["laplace6_launch"], dev, p.data_ptr(),
                      out.data_ptr(), Z, Y, X, Y + 6, X + 6, 3, 3, 3, ix2,
                      iy2, iz2, run)

    field = buf[:numel].view(padded)
    odd = buf[1:].view(padded)   # 4 bytes past 8: 4-byte copies
    cases = {f"{shape} z run {r}": (field, r)
             for r in (zrun,) + LAPLACE6_SWEEPS[shape]}
    cases[f"{shape} 4-byte copies, z run {zrun}"] = (odd, zrun)
    for name, (p, run) in cases.items():
        out.fill_(float("nan"))
        launch(p, run)
        want = cs.laplace6_plain(p, Radius.constant(3), Dim3(X, Y, Z), inv)
        if not torch.equal(out, want):
            raise AssertionError(f"B8 {name} differs from its twin")
        del want
    bound = smoke.bound_ms(4.0 * (numel + Z * Y * X), 34.0 * Z * Y * X)[0]
    calls = {k: (lambda p=p, run=run: launch(p, run),)
             for k, (p, run) in cases.items()}
    turns = time_in_turns(calls, {
        "device": lambda fn: smoke.device_ms(torch, fn, 20, warmup=3)})
    res = {}
    for name in cases:
        ms = sum(turns[name]["device"]) / 2
        res[name] = {"device_ms": ms, "turns": turns[name]["device"],
                     "share": bound / ms}
        print(f"  {name}: {ms!r} ms device ({turns[name]['device']}), "
              f"{100 * bound / ms:.1f}% of bound", flush=True)
    return res


def exchange(args, m: Measuring, log: io.StringIO) -> dict:
    import inspect

    import torch

    from stencil_tpu_torch.distributed import DistributedDomain
    from stencil_tpu_torch.geometry import Radius
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    smoke, n, card = m.smoke, 256, "cuda:0"
    layouts = hasattr(DistributedDomain, "set_wire_layout")

    def domain(s, layout=None):
        dd = DistributedDomain(2 * n, 2 * n, n, devices=[card] * 4)
        dd.set_mesh_shape((2, 2, 1))
        dd.set_radius(Radius.face_edge_corner(2, 2, 2))
        if layout is not None:
            dd.set_wire_layout(layout)
        if s > 1:
            dd.set_exchange_every(s)
        dd.add_data("q0", torch.float32)
        dd.realize()
        return (dd.exchange, dd)

    cases = {f"slab s={s}": domain(s) for s in (1, 2, 4)}
    if layouts:
        cases["irredundant s=1"] = domain(1, "irredundant")
    turns = time_in_turns(cases, {"ms": lambda fn: smoke.event_ms(
        torch, fn, 30, warmup=3)})
    res = {"exchange_ms": {}}
    for name, (_, dd) in cases.items():
        ms = sum(turns[name]["ms"]) / 2
        res["exchange_ms"][name] = {"ms": ms, "turns_ms": turns[name]["ms"],
                                    "bytes": dd.exchange_bytes_total()}
        print(f"{args.label}: exchange {name}: {ms!r} ms "
              f"({turns[name]['ms']}), {dd.exchange_bytes_total()} B",
              flush=True)
    del cases
    torch.cuda.empty_cache()
    if args.paths:
        wires = "wire_format" in inspect.signature(Jacobi3D).parameters
        res["paths"] = {}
        for kernel, k in (("xla", 20), ("pallas", 40)):
            for label, kw in (("f32 slab", {}),
                              ("f32 irredundant",
                               {"wire_layout": "irredundant"}),
                              ("bf16 irredundant",
                               {"wire_format": "bf16",
                                "wire_layout": "irredundant"})):
                if kw and not wires:
                    continue
                j = smoke.jacobi_mesh(kernel, (1, 2, 2),
                                      (2 * n, 2 * n, 2 * n), **kw)
                j.run(2)
                j.block()
                rate, runs = smoke.timed_runs(j, k)
                res["paths"][f"{kernel} {label}"] = [rate, runs]
                print(f"{args.label}: path {kernel} {label} (1,2,2): "
                      f"{rate!r} steps/s ({runs})", flush=True)
                del j
                torch.cuda.empty_cache()
    res["ptxas"] = {}
    return res


MODELS = {"jacobi": jacobi, "mhd": mhd, "pair": pair, "laplace6": laplace6,
          "exchange": exchange}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=tuple(MODELS), default="jacobi")
    ap.add_argument("--root", default=str(TREE))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--baseline", action="store_true",
                    help="with --model mhd: B14's z-streaming baseline")
    ap.add_argument("--plans", action="store_true",
                    help="with --model laplace6: B8 at other launch plans")
    ap.add_argument("--bf16", action="store_true",
                    help="with --model jacobi, mhd or pair: bfloat16 "
                         "fields")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    m = Measuring()

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    card = m.smoke.card_line()
    log = io.StringIO()
    res = {"model": args.model, "label": args.label, "card": card,
           "root": args.root}
    res.update(MODELS[args.model](args, m, log))
    for name, use in res["ptxas"].items():
        print(f"{args.label}: ptxas {name}: {use}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    model = args.model + ("_bf16" if args.bf16 else "")
    path = os.path.join("chiprun_out",
                        f"kernel_times_{model}_{args.label}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
