"""Checker 2: every remote store is ordered by a flag or an event.

PyTorch-port counterpart of ``stencil_tpu/analysis/dma.py``. JAX proves
from one launch's jaxpr that each remote DMA is started once per
semaphore arm and waited on both ends. The port's remote stores are
kernels that write into another card's (or position's) buffers, ordered
by the schedules ``analysis/schedule.py`` writes out as programs; here
one exchange (and the step after it, for rule (a)) is read statically:

* balance: every wait has a signal of its key and value in the schedule
  (on the card it names), so no wait can hang on a signal nobody sends;
* rule (a): every launch that stores into a buffer another stream reads
  is preceded, in its own program, by a wait whose signal its reader
  sends after reading the buffer's previous contents (the READ flag, or
  the ``read`` event within one rank);
* a kernel declared local (B5) has no flag at all, so that it never
  gains one unreviewed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

from .report import Finding
from .schedule import ScheduleSpec, _key


@dataclasses.dataclass
class DmaTarget:
    name: str
    build: Callable[[], ScheduleSpec]

    checker = "dma"


def balance(programs) -> List[str]:
    signals = {(_key(st.op), st.op.value) for prog in programs.values()
               for st in prog if st.op.op == "signal"}
    out = []
    for prog in programs.values():
        for st in prog:
            if st.op.op == "wait" and (_key(st.op), st.op.value) \
                    not in signals:
                out.append(f"wait {_key(st.op)} >= {st.op.value} "
                           f"({st.label}) has no signal of that value")
    return out


def rule_a(programs) -> List[str]:
    """Each store into (buffer, phase p) waits, before its launch, for a
    signal its every reader of phase p - 1 sends after that read."""
    readers = {}
    for k, prog in programs.items():
        for n, st in enumerate(prog):
            for b in st.reads:
                readers.setdefault(b, []).append((k, n))
    signal_at = {}
    for k, prog in programs.items():
        for n, st in enumerate(prog):
            if st.op.op == "signal":
                signal_at.setdefault((_key(st.op), st.op.value),
                                     []).append((k, n))
    out = []
    for k, prog in programs.items():
        for n, st in enumerate(prog):
            if st.op.op != "launch":
                continue
            waits = [w for w in prog[:n] if w.op.op == "wait"]
            for buf, phase in st.writes:
                for rk, rn in readers.get((buf, phase - 1), ()):
                    if rk == k:
                        continue
                    ok = any(sk == rk and sn > rn
                             for w in waits
                             for sk, sn in signal_at.get(
                                 (_key(w.op), w.op.value), ()))
                    if not ok:
                        out.append(
                            f"{st.label} stores into {buf} of phase {phase} "
                            f"with no wait for its reader "
                            f"{programs[rk][rn].label} (rule (a))")
    return out


def check_dma(target: DmaTarget):
    try:
        spec = target.build()
    except Exception as e:  # noqa: BLE001
        return [Finding("dma", target.name,
                        f"target build failed: {type(e).__name__}: {e}")]
    programs = spec.programs(2)
    findings = [Finding("dma", target.name, m)
                for m in balance(programs) + rule_a(programs)]
    flags = sum(st.op.op != "launch" for prog in programs.values()
                for st in prog)
    stores = sum(len(st.writes) for prog in programs.values()
                 for st in prog)
    if spec.expect_remote and not stores:
        findings.append(Finding("dma", target.name,
                                "no remote store found: nothing checked"))
    if not spec.expect_remote and (flags or stores):
        findings.append(Finding(
            "dma", target.name,
            f"a kernel declared local has {flags} flag step(s) and "
            f"{stores} remote store(s)"))
    return findings, {"flag_steps": flags, "remote_stores": stores,
                      "streams": len(programs)}
