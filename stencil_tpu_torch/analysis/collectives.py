"""Checker 3: every message meets its receive, and along each axis the
messages are a permutation of the mesh line.

PyTorch-port counterpart of ``stencil_tpu/analysis/collectives.py``
(every ``ppermute`` is a bijection of its mesh axis). The port's
exchanges move messages between mesh positions: in one process a
``_ship``/``copy_`` from one shard to another, which the engine's probe
records with its source and destination (``WireProbe.messages``);
across ranks point-to-point messages through ``torch.distributed``
(``multihost.RankMessages``). Both are checked:

* one process: the messages of each axis, grouped by their shift along
  it (destination minus source position, modulo the axis), go from
  every position of the mesh to the position that shift away on the
  same line, each position as often as every other (a bijection of each
  line, repeated per quantity and sweep); an all-gather (``shape``
  "gather") brings every position's slab to its line;
* every mesh position a rank of its own (``probes.DistShim`` runs each
  rank's view): every send meets a receive of the same tag and bytes at
  its peer, and every receive a send.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, List

from ..parallel.mesh import mesh_index
from .entries import ExchangeSpec, probe_messages, rank_calls
from .probes import unmatched_messages
from .report import Finding

_AXIS = {"x": 0, "y": 1, "z": 2}


@dataclasses.dataclass
class CollectiveTarget:
    name: str
    build: Callable[[], ExchangeSpec]

    checker = "collectives"


def line_violations(messages, counts, shape: str = "bijection") -> List[str]:
    """What breaks the bijection (or the gather) in one process's
    ``messages`` ((axis, src, dst, bytes) each)."""
    out = []
    n = counts.flatten()
    if shape == "gather":
        for axis in sorted({m[0] for m in messages}):
            srcs = {m[1] for m in messages if m[0] == axis}
            if srcs != set(range(n)):
                out.append(f"axis {axis}: positions "
                           f"{sorted(set(range(n)) - srcs)} never reach "
                           f"their line")
        return out
    groups = {}
    for axis, src, dst, _ in messages:
        a = _AXIS[axis]
        si, di = mesh_index(src, counts), mesh_index(dst, counts)
        if any(si[b] != di[b] for b in range(3) if b != a):
            out.append(f"axis {axis}: message {src} -> {dst} leaves its "
                       f"mesh line")
            continue
        shift = (di[a] - si[a]) % counts[a]
        groups.setdefault((axis, shift), []).append((src, dst))
    for (axis, shift), pairs in sorted(groups.items()):
        srcs, dsts = Counter(s for s, _ in pairs), Counter(d for _, d in
                                                           pairs)
        if shift == 0:
            out.append(f"axis {axis}: {len(pairs)} message(s) from a "
                       f"position to itself")
            continue
        if set(srcs) != set(range(n)) or set(dsts) != set(range(n)) \
                or len(set(srcs.values()) | set(dsts.values())) != 1:
            out.append(f"axis {axis}, shift {shift}: the messages are not "
                       f"a permutation of each line (sources "
                       f"{dict(srcs)}, destinations {dict(dsts)})")
    return out


def check_collectives(target: CollectiveTarget):
    try:
        spec = target.build()
    except Exception as e:  # noqa: BLE001
        return [Finding("collectives", target.name,
                        f"target build failed: {type(e).__name__}: {e}")]
    probe = probe_messages(spec)
    findings = [Finding("collectives", target.name, m)
                for m in line_violations(probe.messages, spec.counts,
                                         spec.shape)]
    if not probe.messages:
        findings.append(Finding("collectives", target.name,
                                "no message between mesh positions: "
                                "nothing checked"))
    calls = rank_calls(spec)
    findings += [Finding("collectives", target.name, m)
                 for m in unmatched_messages(calls)]
    sends = sum(c.name == "isend" for c in calls)
    if not sends:
        findings.append(Finding("collectives", target.name,
                                "no message between ranks: nothing "
                                "checked"))
    return findings, {"messages": len(probe.messages),
                      "rank_messages": sends,
                      "ranks": len(set(spec.rank_list()))}
