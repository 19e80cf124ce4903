"""Deterministic fault injection: every recovery path is rehearsable.

PyTorch-port counterpart of ``stencil_tpu/resilience/faults.py``, ported
whole. The port's state is per shard (``fields[q]`` a list of tensors
over the mesh positions, None at another rank's), so an injection writes
into the owning rank's local shard in place (``_shard_cell``), and
:class:`CheckpointCorruption` damages the port's own checkpoint files
(``utils/checkpoint.py``; ``_state_data_files``), each rank its own
shards' files.

A recovery path that has never run is a bug that hasn't happened yet.
This module makes the failure modes of a long campaign *injectable* —
seeded, step-addressed, CPU-runnable — so tier-1 tests (and the CI
chaos-smoke stage) pin rollback, retry, fallback, and preemption
behavior deterministically, the way TEMPI (arXiv:2012.14363) rehearses
its interposed degradation paths.

Fault classes (all dataclasses on a :class:`FaultPlan`):

* :class:`NaNInjection` — poison an interior cell of a chosen shard at
  a chosen step (a compute blow-up).
* :class:`HaloCorruption` — poison a halo (pad) cell post-step (a
  poisoned exchange; the sentinel probes padded fields exactly so this
  is caught even though the next exchange would overwrite it).
* :class:`ParticleLoss` — corrupt live particle records of a chosen
  shard (NaN a SoA lane; the PIC analog of lost particle memory —
  recovery restores the particle checkpoint extras).
* :class:`TransientSaveFailure` — the next checkpoint save raises
  ``IOError`` for the first N attempts (an NFS blip mid-checkpoint).
* :class:`CheckpointCorruption` — after checkpoint ``step`` lands on
  disk, truncate or bit-flip one of its data files (bit-rot; restore
  must fall back to an older step).
* :class:`Preemption` — deliver a real ``SIGTERM`` to this process at
  a chosen step (the fleet scheduler reclaiming the host).

Fleet-level fault classes (consumed by :class:`~..serving.fleet.
Fleet` rather than the single-process resilience driver; ``step`` is
the fleet serving ROUND, not a member step):

* :class:`ReplicaCrash` — hard-kill one replica mid-batch: its
  in-RAM lanes and unresolved handles are lost; recovery must come
  from the per-tenant checkpoint namespaces on the shared root.
* :class:`SlowReplica` — degrade one replica: the fleet's ladder
  drains it, reshards its tenants to survivors, and readmits it at
  ``recover_step``.
* :class:`AdmissionFlood` — a burst of low-priority junk requests
  that must be SHED loudly (request_shed events + counter), never
  allowed to starve protected tenants.

Each event fires at most ``repeat`` times, so a transient fault
disappears on the retry pass while a persistent one (``repeat`` large)
keeps tripping until the driver degrades the configuration.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch

from ..utils.logging import LOG_WARN

LogFn = Callable[..., None]


def _noop_log(kind: str, **kw) -> None:  # pragma: no cover - default
    pass


@dataclasses.dataclass
class NaNInjection:
    """Write NaN into the interior center of shard ``shard`` of
    ``quantity`` (first registered quantity when None) right after step
    ``step`` completes."""

    step: int
    quantity: Optional[str] = None
    shard: Tuple[int, int, int] = (0, 0, 0)
    repeat: int = 1
    fired: int = 0

    def due(self, step: int) -> bool:
        return step == self.step and self.fired < self.repeat

    def fire(self, dd, log: LogFn, fields=None) -> None:
        self.fired += 1
        fields = dd.curr if fields is None else fields
        q = self.quantity or dd._names[0]
        i, local, cell = _shard_cell(dd, self.shard, interior=True,
                                     arr=fields[q])
        _poison(fields[q][i], local)
        log("fault_nan", step=self.step, quantity=q,
            shard=list(self.shard), cell=cell)


@dataclasses.dataclass
class HaloCorruption:
    """Write NaN into a halo (pad) cell of shard ``shard`` after step
    ``step`` — the signature of a poisoned exchange."""

    step: int
    quantity: Optional[str] = None
    shard: Tuple[int, int, int] = (0, 0, 0)
    repeat: int = 1
    fired: int = 0

    def due(self, step: int) -> bool:
        return step == self.step and self.fired < self.repeat

    def fire(self, dd, log: LogFn, fields=None) -> None:
        self.fired += 1
        fields = dd.curr if fields is None else fields
        q = self.quantity or dd._names[0]
        got = _shard_cell(dd, self.shard, interior=False, arr=fields[q])
        if got is None:
            LOG_WARN("HaloCorruption: the live fields carry no halo "
                     "pads (radius 0 or interior-resident fast path); "
                     "fault is a no-op")
            return
        i, local, cell = got
        _poison(fields[q][i], local)
        log("fault_halo", step=self.step, quantity=q,
            shard=list(self.shard), cell=cell)


@dataclasses.dataclass
class ParticleLoss:
    """Corrupt ``count`` live particle records of shard ``shard``
    after step ``step`` (the PIC analog of a lost/rotted memory lane):
    the ``quantity`` lane of the chosen slots is set to NaN. Detection
    is guaranteed two ways on the next probe — the lane itself is
    probed non-finite by the PIC sentinel, and the next deposition
    scatters the NaN charge into ``rho``. Recovery must restore the
    particle lanes from the checkpoint extras and end bitwise-equal to
    the fault-free run.

    The live field dict must carry the particle SoA lanes (the PIC
    model's ``fields_fn`` contract) and the domain must expose
    ``particle_capacity`` (``models/pic.py`` stamps it) so the shard's
    slot block can be located under the ``P(('z','y','x'))`` layout."""

    step: int
    count: int = 1
    shard: Tuple[int, int, int] = (0, 0, 0)
    quantity: str = "q"
    repeat: int = 1
    fired: int = 0

    def due(self, step: int) -> bool:
        return step == self.step and self.fired < self.repeat

    def fire(self, dd, log: LogFn, fields=None) -> None:
        self.fired += 1
        cap = getattr(dd, "particle_capacity", None)
        if fields is None or cap is None or self.quantity not in fields:
            LOG_WARN("ParticleLoss: no particle state on this domain "
                     "(particle_capacity / particle lanes absent); "
                     "fault is a no-op")
            return
        bx, by, bz = self.shard
        dim = dd.placement.dim()
        i = (bz * dim.y + by) * dim.x + bx
        base = i * cap
        lane = fields[self.quantity][i]
        valid = fields.get("valid")
        if lane is None:
            # another rank owns the shard: it writes, every rank logs
            slots = None
        elif valid is not None:
            live = torch.nonzero(valid[i]).flatten()[:self.count].tolist()
            slots = [int(s) for s in live]
        else:
            slots = list(range(self.count))
        if dd.mesh.spans_ranks:
            from ..parallel.multihost import all_gather_objects

            slots = all_gather_objects(slots)[dd.mesh.ranks[i]]
        if not slots:
            LOG_WARN(f"ParticleLoss: shard {self.shard} holds no live "
                     f"particles at step {self.step}; fault is a no-op")
            return
        if lane is not None:
            lane[slots] = float("nan")
        log("fault_particle_loss", step=self.step, quantity=self.quantity,
            shard=list(self.shard), slots=[base + s for s in slots])


@dataclasses.dataclass
class TransientSaveFailure:
    """The checkpoint save at step ``step`` raises ``IOError`` for its
    first ``failures`` attempts, then succeeds (exercises the retry/
    backoff path without touching the filesystem)."""

    step: int
    failures: int = 2
    fired: int = 0

    def maybe_raise(self, step: int, log: LogFn) -> None:
        if step == self.step and self.fired < self.failures:
            self.fired += 1
            log("fault_save_ioerror", step=step, attempt=self.fired)
            raise IOError(
                f"injected transient save failure "
                f"{self.fired}/{self.failures} at step {step}")


@dataclasses.dataclass
class CheckpointCorruption:
    """After checkpoint ``step`` is written, corrupt its data files on
    disk (this rank's shards' files): ``mode='truncate'`` halves each,
    ``mode='bitflip'`` flips one seeded byte of each. Restore must
    detect either (a short file or an integrity sha256 mismatch) and
    fall back."""

    step: int
    mode: str = "truncate"
    repeat: int = 1
    fired: int = 0

    def due(self, step: int) -> bool:
        return step == self.step and self.fired < self.repeat

    def fire(self, directory: str, step: int, rng, log: LogFn,
             positions=None) -> None:
        self.fired += 1
        targets = _state_data_files(directory, step, positions)
        if not targets:  # pragma: no cover - layout drift guard
            LOG_WARN(f"CheckpointCorruption: no data file under "
                     f"{directory}/{step}; fault is a no-op")
            return
        for target in targets:
            data = bytearray(target.read_bytes())
            if self.mode == "truncate":
                target.write_bytes(bytes(data[:max(len(data) // 2, 1)]))
            elif self.mode == "bitflip":
                i = int(rng.integers(0, len(data)))
                data[i] ^= 0xFF
                target.write_bytes(bytes(data))
            else:
                raise ValueError(f"unknown corruption mode {self.mode!r}")
        log("fault_ckpt_corruption", step=step, mode=self.mode,
            files=[str(t) for t in targets])


@dataclasses.dataclass
class Preemption:
    """Deliver ``SIGTERM`` to this process after step ``step`` — the
    driver's handler turns it into a final 'preempted' checkpoint and a
    clean exit, exactly like a fleet scheduler reclaiming the host."""

    step: int
    fired: int = 0

    def due(self, step: int) -> bool:
        return step == self.step and self.fired < 1

    def fire(self, log: LogFn) -> None:
        self.fired += 1
        log("fault_preemption", step=self.step)
        os.kill(os.getpid(), signal.SIGTERM)


@dataclasses.dataclass
class ReplicaCrash:
    """Hard-kill replica ``replica`` during the fleet round ``step``:
    the fleet arms the replica's crash hook so the kill lands at
    member step ``at_member_step`` INSIDE its next batch (after that
    boundary's checkpoints — state newer than the last periodic
    checkpoint is genuinely lost). No handles resolve, nothing is
    checkpointed at the kill point: recovery must re-admit the
    replica's campaigns to survivors from the per-tenant checkpoint
    namespaces, bitwise-continuous."""

    step: int
    replica: int = 0
    at_member_step: int = 0
    repeat: int = 1
    fired: int = 0

    def due(self, step: int) -> bool:
        return step == self.step and self.fired < self.repeat

    def fire(self, log: LogFn) -> None:
        self.fired += 1
        log("fault_replica_crash", step=self.step,
            replica=self.replica, at_member_step=self.at_member_step)


@dataclasses.dataclass
class SlowReplica:
    """Mark replica ``replica`` degraded at fleet round ``step``: the
    fleet trips its degradation ladder (drain -> reshard its tenants
    to survivors -> readmit on recovery). ``recover_step`` is the
    fleet round at which the replica rejoins the active set (None =
    it stays degraded)."""

    step: int
    replica: int = 0
    recover_step: Optional[int] = None
    repeat: int = 1
    fired: int = 0
    restored: int = 0

    def due(self, step: int) -> bool:
        return step == self.step and self.fired < self.repeat

    def fire(self, log: LogFn) -> None:
        self.fired += 1
        log("fault_slow_replica", step=self.step, replica=self.replica,
            recover_step=self.recover_step)

    def recover_due(self, step: int) -> bool:
        return (self.recover_step is not None and self.fired > 0
                and self.restored < self.fired
                and step >= self.recover_step)

    def recover(self, log: LogFn) -> None:
        self.restored += 1
        log("fault_slow_replica_recovered", step=self.recover_step,
            replica=self.replica)


@dataclasses.dataclass
class AdmissionFlood:
    """Submit ``count`` junk campaigns from ``tenant`` at ``priority``
    (below the fleet policy's protected floor by default) during fleet
    round ``step`` — the overload that must be SHED with a named
    reason, not silently queued until protected tenants starve."""

    step: int
    tenant: str = "flood"
    count: int = 8
    priority: int = 0
    n_steps: int = 1
    grid: Tuple[int, int, int] = (8, 8, 8)
    repeat: int = 1
    fired: int = 0

    def due(self, step: int) -> bool:
        return step == self.step and self.fired < self.repeat

    def fire(self, log: LogFn) -> None:
        self.fired += 1
        log("fault_admission_flood", step=self.step, tenant=self.tenant,
            count=self.count, priority=self.priority)


@dataclasses.dataclass
class FaultPlan:
    """A seeded schedule of injected faults, consumed by the resilience
    driver. All hooks are no-ops when their event lists are empty, so a
    production run with ``faults=None`` pays nothing."""

    nans: List[NaNInjection] = dataclasses.field(default_factory=list)
    halos: List[HaloCorruption] = dataclasses.field(default_factory=list)
    particle_losses: List[ParticleLoss] = \
        dataclasses.field(default_factory=list)
    save_failures: List[TransientSaveFailure] = \
        dataclasses.field(default_factory=list)
    ckpt_corruptions: List[CheckpointCorruption] = \
        dataclasses.field(default_factory=list)
    preemptions: List[Preemption] = dataclasses.field(default_factory=list)
    seed: int = 0

    def __post_init__(self) -> None:
        import numpy as np
        self._rng = np.random.default_rng(self.seed)
        self._log: LogFn = _noop_log

    def bind(self, log: LogFn) -> None:
        """Route fault firings into the driver's event log."""
        self._log = log

    # -- driver hooks ---------------------------------------------------
    def on_step(self, dd, step: int, fields=None) -> bool:
        """Fire state faults due after ``step`` (NaN, halo, SIGTERM).
        ``fields`` is the LIVE field dict (the driver passes the same
        one the sentinel probes) — on interior-resident fast paths
        that is the model's resident state, not the stale ``dd.curr``;
        it is mutated in place. Defaults to ``dd.curr``. Returns True
        when a STATE fault (NaN/halo) fired — the fused megastep loop
        re-probes the now-poisoned fields so detection matches the
        stepwise loop's post-injection probe semantics."""
        mutated = False
        for ev in self.nans:
            if ev.due(step):
                ev.fire(dd, self._log, fields)
                mutated = True
        for ev in self.halos:
            if ev.due(step):
                ev.fire(dd, self._log, fields)
                mutated = True
        for ev in self.particle_losses:
            if ev.due(step):
                ev.fire(dd, self._log, fields)
                mutated = True
        for ev in self.preemptions:
            if ev.due(step):
                ev.fire(self._log)
        return mutated

    def next_host_step(self, after: int) -> Optional[int]:
        """The next step at which a host-side hook must run (NaN, halo,
        SIGTERM still due) — the fused megastep loop cuts segments at
        these boundaries so host fault injection lands between
        dispatches exactly where the stepwise loop would fire it.
        None when no such fault remains."""
        cands = [ev.step
                 for ev in (*self.nans, *self.halos,
                            *self.particle_losses, *self.preemptions)
                 if ev.step > after
                 and ev.fired < getattr(ev, "repeat", 1)]
        return min(cands) if cands else None

    def maybe_fail_save(self, step: int) -> None:
        """Raise the scheduled transient ``IOError`` for this save."""
        for ev in self.save_failures:
            ev.maybe_raise(step, self._log)

    def after_save(self, directory: str, step: int,
                   positions=None) -> None:
        """Fire on-disk corruption due for the checkpoint just saved
        (the files of ``positions``, this rank's shards; all when
        None)."""
        for ev in self.ckpt_corruptions:
            if ev.due(step):
                ev.fire(directory, step, self._rng, self._log, positions)


# ----------------------------------------------------------------------
# geometry helpers
# ----------------------------------------------------------------------
def _poison(t, local: Tuple[int, int, int]) -> None:
    """NaN at ``local`` of this rank's shard ``t`` (None: another rank's
    shard, which that rank writes)."""
    if t is not None:
        z, y, x = local
        t[z, y, x] = float("nan")


def _shard_cell(dd, shard: Tuple[int, int, int], interior: bool,
                arr=None):
    """``(i, local, cell)`` for a cell of shard ``(bx, by, bz)``: its
    position ``i`` in the shard lists, the (z, y, x) index in that
    shard's tensor, and the index JAX's global padded array gives the
    same cell (what the event logs): the interior center
    (``interior=True``) or the first halo pad cell of the first padded
    axis (``interior=False``; None when the tensors have no pads).
    ``arr`` (the live shard list) tells the padded layout (``dd.curr``)
    from the interior-resident one of the fast paths (no pads: halo
    corruption is a no-op there)."""
    from ..geometry import Dim3
    from ..local_domain import raw_size, zyx_shape
    bx, by, bz = shard
    dim = dd.placement.dim()
    i = (bz * dim.y + by) * dim.x + bx
    pr = raw_size(dd.local_size, dd.alloc_radius)
    lo = dd.alloc_radius.pad_lo()
    t = None if arr is None else next((s for s in arr if s is not None),
                                      None)
    if t is not None and tuple(t.shape[-3:]) != zyx_shape(pr):
        if not interior:
            return None        # interior-resident: nothing to corrupt
        pr = dd.local_size
        lo = Dim3(0, 0, 0)
    center = (lo.z + dd.local_size.z // 2, lo.y + dd.local_size.y // 2,
              lo.x + dd.local_size.x // 2)
    if interior:
        local = center
    elif lo.z > 0:   # first z-lo pad row of this shard, centered in y/x
        local = (0, center[1], center[2])
    elif lo.y > 0:
        local = (center[0], 0, center[2])
    elif lo.x > 0:
        local = (center[0], center[1], 0)
    else:
        return None
    base = (bz * pr.z, by * pr.y, bx * pr.x)
    return i, local, [b + c for b, c in zip(base, local)]


def _state_data_files(directory: str, step: int,
                      positions=None) -> List[Path]:
    """The data files of checkpoint ``step`` (``<key>.<i>.bin``, where
    the array bytes live, so corrupting them is guaranteed to hit data,
    not the meta record), those of ``positions`` only when given."""
    root = Path(directory).absolute() / str(step)
    if not root.is_dir():
        return []
    files = [p for p in sorted(root.glob("*.bin")) if p.is_file()]
    if positions is not None:
        own = {int(p) for p in positions}
        files = [p for p in files if int(p.name.split(".")[-2]) in own]
    return files
