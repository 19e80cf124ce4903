"""Checker 1: a stencil op reads no cell beyond its declared Radius.

PyTorch-port counterpart of ``stencil_tpu/analysis/footprint.py``. JAX
collects the op's static slices from its jaxpr; the port has no program
to read, so it runs the op. For each of the 26 directions d and each
depth k the allocation has there, the cells of the halo box of d at
depth k (depth exactly k beyond the interior along every axis d moves
along, the interior's range along the others) are set to NaN in every
padded input, the op runs, and the box counts as read when any output
turns NaN. NaN survives a multiply by a zero weight, so every read
shows, and an op that reads a box reads it whatever the other values.
The required radius of d is the deepest box read: for an op that reads
by slices this is JAX's ``required_radius`` (the largest, over the
slices, of the least reach along d's axes). A declared radius below it
is an error.

The allocation may be deeper than the declared radius (``pad_lo`` /
``pad_hi``), so that a read one row too far lands in NaN instead of
outside the tensor. On the card (the ``cuda.`` targets) the same probe
runs over a kernel's wrapper; slab-fed kernels (B5, B6, B11), whose
halos are slabs rather than pads, have their slabs' filler rows beyond
the radius poisoned (the outputs must stay finite: JAX's rz = ry = 8
layout puts filler there) and each slab's rows within it (some output
must turn NaN: the probe is not vacuous).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..geometry import Dim3, Radius
from .report import ERROR, WARNING, Finding

Direction = Tuple[int, int, int]


def all_directions() -> List[Direction]:
    """The 26 (x, y, z) directions."""
    return [d for d in itertools.product((-1, 0, 1), repeat=3)
            if d != (0, 0, 0)]


def dir_name(d: Direction) -> str:
    return "(" + ",".join(f"{v:+d}" if v else "0" for v in d) + ")"


@dataclasses.dataclass
class StencilOpSpec:
    """A stencil op to probe: ``fn(*padded)`` returns a tensor or a tuple
    of them; each of the ``n_inputs`` padded inputs has the (z, y, x)
    ``shape``, low pads ``pad_lo`` (default the declared ``radius``'s)
    around the ``interior``. ``launches()`` (the card targets): the
    wrapper's launch count, which must grow by one a run."""
    fn: Callable[..., Any]
    shape: Tuple[int, int, int]
    radius: Radius
    interior: Dim3
    pad_lo: Optional[Dim3] = None
    n_inputs: int = 1
    dtype: torch.dtype = torch.float32
    device: str = "cpu"
    launches: Optional[Callable[[], int]] = None


@dataclasses.dataclass
class StencilOpTarget:
    name: str
    build: Callable[[], StencilOpSpec]

    checker = "footprint"


@dataclasses.dataclass
class SlabKernelSpec:
    """A slab-fed kernel: ``make()`` gives fresh (args, slabs), where
    ``slabs`` lists (name, tensor, halo, filler): the slices of the
    tensor's rows within the declared radius (``halo``) and the list of
    slices of those beyond it (``filler``); ``fn(*args)`` runs the
    kernel (it reads the slab tensors ``make`` handed out)."""
    fn: Callable[..., Any]
    make: Callable[[], Tuple[Sequence, List[Tuple[str, torch.Tensor,
                                                  Tuple, List[Tuple]]]]]
    launches: Optional[Callable[[], int]] = None


def slab_regions(name: str, t: torch.Tensor, n: int,
                 zext: int = 0, interior_z: int = 0
                 ) -> Tuple[Tuple, List[Tuple]]:
    """(halo, filler) slices of slab ``name`` (``zlo``/``zhi`` (rz, Y, X),
    ``ylo``/``yhi`` (Zs, e, X), leading dimensions allowed) whose ``n``
    rows next to the interior are the halo; ``zext`` > 0: the y slabs
    span ``zext`` z rows on each side of the ``interior_z`` planes, of
    which the ``n`` nearest are halo too."""
    lead = (slice(None),) * (t.dim() - 3)
    dim = -3 if name.startswith("z") else -2
    size = t.shape[dim]
    near = (slice(size - n, size) if name.endswith("lo")
            else slice(0, n))
    far = (slice(0, size - n) if name.endswith("lo") else slice(n, size))
    full = slice(None)
    if dim == -3:
        return lead + (near, full, full), [lead + (far, full, full)]
    filler = [lead + (full, far, full)]
    zs = slice(None)
    if zext:
        zs = slice(zext - n, zext + interior_z + n)
        filler += [lead + (slice(0, zext - n), near, full),
                   lead + (slice(zext + interior_z + n, t.shape[-3]),
                           near, full)]
    return lead + (zs, near, full), filler


def _outputs(out) -> List[torch.Tensor]:
    """Every tensor of ``out`` (a tensor, or nested dicts, lists and
    tuples of them)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _outputs(v)]
    return []


def _any_nan(out) -> bool:
    return any(bool(torch.isnan(t.float()).any()) for t in _outputs(out))


def _box(d: Direction, k: int, lo: Sequence[int], n: Sequence[int]):
    """The (z, y, x) slices of direction d's halo box at depth k (``lo``
    and ``n``: the low pads and interior, (x, y, z))."""
    sl = []
    for a in (2, 1, 0):
        if d[a] == 0:
            sl.append(slice(lo[a], lo[a] + n[a]))
        elif d[a] > 0:
            sl.append(slice(lo[a] + n[a] + k - 1, lo[a] + n[a] + k))
        else:
            sl.append(slice(lo[a] - k, lo[a] - k + 1))
    return tuple(sl)


def _depths(d: Direction, lo: Sequence[int], n: Sequence[int],
            shape_xyz: Sequence[int]) -> int:
    """The deepest box of d the allocation holds."""
    out = []
    for a in range(3):
        if d[a] > 0:
            out.append(shape_xyz[a] - lo[a] - n[a])
        elif d[a] < 0:
            out.append(lo[a])
    return min(out)


def _inputs(spec: StencilOpSpec, seed: int) -> List[torch.Tensor]:
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(spec.shape, generator=gen).to(spec.dtype).to(
        spec.device) for _ in range(spec.n_inputs)]


def probe_radius(spec: StencilOpSpec, seed: int = 7
                 ) -> Tuple[Dict[Direction, int], int]:
    """(the deepest box read in each direction, the runs made). Raises
    what the op raises (a read outside the allocation)."""
    lo = tuple(spec.pad_lo if spec.pad_lo is not None
               else spec.radius.pad_lo())
    n = tuple(spec.interior)
    shape_xyz = (spec.shape[2], spec.shape[1], spec.shape[0])
    base = _inputs(spec, seed)
    runs = 0
    with torch.no_grad():
        if _any_nan(spec.fn(*[t.clone() for t in base])):
            raise ValueError("the op gives NaN on finite inputs")
        runs += 1
        reach: Dict[Direction, int] = {}
        for d in all_directions():
            reach[d] = 0
            for k in range(1, _depths(d, lo, n, shape_xyz) + 1):
                box = _box(d, k, lo, n)
                ins = [t.clone() for t in base]
                for t in ins:
                    t[box] = float("nan")
                runs += 1
                if _any_nan(spec.fn(*ins)):
                    reach[d] = k
    return reach, runs


def check_stencil_op(target: StencilOpTarget):
    """Prove (or refute) that the target's declared Radius covers what it
    reads in all 26 directions."""
    try:
        spec = target.build()
    except Exception as e:  # noqa: BLE001 - any build error is a finding
        return [Finding("footprint", target.name,
                        f"target build failed: {type(e).__name__}: {e}")]
    before = spec.launches() if spec.launches else None
    try:
        reach, runs = probe_radius(spec)
    except Exception as e:  # noqa: BLE001 - a read outside lands here
        return [Finding("footprint", target.name,
                        f"probe failed (the op reads outside its padded "
                        f"allocation?): {type(e).__name__}: {e}")]
    findings: List[Finding] = []
    if spec.launches is not None and spec.launches() - before != runs:
        findings.append(Finding(
            "footprint", target.name,
            f"{spec.launches() - before} kernel launches for {runs} "
            f"probe runs: the probe did not run the kernel"))
    for d, need in sorted(reach.items()):
        have = spec.radius.dir(d)
        if have < need:
            findings.append(Finding(
                "footprint", target.name,
                f"direction {dir_name(d)}: declared radius {have} < "
                f"required {need} — the exchange under-delivers halo data "
                f"the op reads", ERROR))
    if not any(reach.values()):
        findings.append(Finding("footprint", target.name,
                                "the op reads no halo cell; nothing to "
                                "verify", WARNING))
    return findings, {"required": {dir_name(d): k for d, k in reach.items()
                                   if k},
                      "probe_runs": runs}


def check_slab_kernel(name: str, spec: SlabKernelSpec):
    """A slab-fed kernel reads each slab's halo rows and none of its
    filler."""
    findings: List[Finding] = []
    runs = 0
    before = spec.launches() if spec.launches else None
    with torch.no_grad():
        args, _ = spec.make()
        if _any_nan(spec.fn(*args)):
            return [Finding("footprint", name,
                            "the kernel gives NaN on finite inputs")]
        runs += 1
        args, slabs = spec.make()
        poisoned = 0
        for _, t, _, filler in slabs:
            for sl in filler:
                if t[sl].numel():
                    t[sl] = float("nan")
                    poisoned += 1
        runs += 1
        if _any_nan(spec.fn(*args)):
            findings.append(Finding(
                "footprint", name,
                "a slab row beyond the declared radius was read (NaN in "
                "the filler reached an output)"))
        for k in range(len(slabs)):
            args, slabs = spec.make()
            sname, t, halo, _ = slabs[k]
            t[halo] = float("nan")
            runs += 1
            if not _any_nan(spec.fn(*args)):
                findings.append(Finding(
                    "footprint", name,
                    f"slab {sname}'s halo rows were not read: the probe is "
                    f"vacuous or the kernel ignores its halo"))
    if spec.launches is not None and spec.launches() - before != runs:
        findings.append(Finding(
            "footprint", name,
            f"{spec.launches() - before} kernel launches for {runs} "
            f"probe runs: the probe did not run the kernel"))
    if not poisoned:
        findings.append(Finding("footprint", name,
                                "no filler row to poison: the layout has "
                                "none beyond the radius", WARNING))
    return findings, {"probe_runs": runs, "filler_slices": poisoned}


@dataclasses.dataclass
class SlabKernelTarget:
    name: str
    build: Callable[[], SlabKernelSpec]

    checker = "footprint"


def check_footprint(target) -> Any:
    """The footprint checker's dispatch: a padded op or a slab-fed
    kernel."""
    if isinstance(target, SlabKernelTarget):
        try:
            spec = target.build()
        except Exception as e:  # noqa: BLE001
            return [Finding("footprint", target.name,
                            f"target build failed: {type(e).__name__}: "
                            f"{e}")]
        return check_slab_kernel(target.name, spec)
    return check_stencil_op(target)
