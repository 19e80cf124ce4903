"""Negative control for the dma checker: B7's schedule on (1, 2, 2) with
every position a rank of its own, but launch A stores into its targets'
receive buffers without waiting for their READ flags (rule (a)), and a
wait whose value no signal ever reaches."""

import dataclasses

from stencil_tpu_torch.analysis.dma import DmaTarget
from stencil_tpu_torch.analysis.schedule import (b7_targets, overlap_spec)
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.parallel import ipc

COUNTS = Dim3(1, 2, 2)


def _no_read_waits():
    spec = overlap_spec("fixture.b7", COUNTS, b7_targets(COUNTS),
                        list(range(4)))
    base = spec.programs

    def programs(k):
        progs = base(k)
        return {i: [st for st in prog
                    if not (st.op.op == "wait" and st.op.kind == ipc.READ)]
                for i, prog in progs.items()}
    spec.programs = programs
    return spec


def _unmatched_wait():
    spec = overlap_spec("fixture.b7", COUNTS, b7_targets(COUNTS),
                        list(range(4)))
    base = spec.programs

    def programs(k):
        progs = base(k)
        st = progs[0][0]
        progs[0].insert(0, dataclasses.replace(
            st, op=ipc.FlagOp("wait", ipc.SENT, 3, 99, st.op.card)))
        return progs
    spec.programs = programs
    return spec


TARGETS = [DmaTarget("fixture.dma.store_before_read_wait", _no_read_waits),
           DmaTarget("fixture.dma.wait_without_signal", _unmatched_wait)]
