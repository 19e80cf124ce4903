"""Negative controls for the schedule checker: B7's schedule with a wait
placed before the signal it needs on the same stream (a deadlock), and
the same schedule with every flag value 1 — a counter re-armed while
the previous phase's stores can still land."""

import dataclasses

from stencil_tpu_torch.analysis.schedule import (ScheduleTarget, b7_targets,
                                                 overlap_spec)
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.parallel import ipc

COUNTS = Dim3(1, 2, 2)


def _spec():
    return overlap_spec("fixture.b7", COUNTS, b7_targets(COUNTS),
                        list(range(4)))


def _wait_before_signal():
    spec = _spec()
    base = spec.programs

    def programs(k):
        progs = base(k)
        # position 0 first waits for its own launch B's READ of step 0,
        # which comes after this wait on the same stream
        st = progs[0][0]
        progs[0].insert(0, dataclasses.replace(
            st, op=ipc.FlagOp("wait", ipc.READ, 0, 1, (1, "cuda:0"))))
        return progs
    spec.programs = programs
    return spec


def _one_value():
    spec = _spec()
    base = spec.programs

    def programs(k):
        return {i: [dataclasses.replace(st, op=dataclasses.replace(
                    st.op, value=1)) if st.op.op != "launch"
                    and st.op.kind in (ipc.SENT, ipc.READ) else st
                    for st in prog]
                for i, prog in base(k).items()}
    spec.programs = programs
    return spec


TARGETS = [ScheduleTarget("fixture.schedule.wait_before_signal",
                          _wait_before_signal),
           ScheduleTarget("fixture.schedule.rearmed_in_flight", _one_value)]
