"""Particle-in-cell model: charged particles on the sharded grid.

PyTorch-port counterpart of ``stencil_tpu/models/pic.py``: an
electrostatic-proxy PIC step over a mesh of shards, with the dynamic,
data-dependent exchange of a PIC code beside the static halo sweep. One
step, per shard:

1. **deposit** — every particle scatters its charge into the
   halo-padded ``rho`` (NGP nearest cell, or CIC trilinear); particles
   at an edge land in pad cells that belong to a neighbour;
2. **reverse halo-accumulate** — ``parallel.exchange.accumulate_shard``
   folds those pad contributions back into the owning interiors;
3. **exchange** — the forward halo sweep fills ``rho``'s pads;
4. **gather** — ``E = -grad rho`` (``ops.stencil_kernels.central_diff``)
   interpolated at the particles with the deposit's weights;
5. **leapfrog push** — ``v += push * dt * q * E``, ``x += v dt``, and
   the CFL guard: a particle that would move more than one shard is
   dropped and counted;
6. **migrate** — ``parallel.migrate.migrate_shard``, the fixed-capacity
   ring, with the overflow count carried per shard.

Each phase runs for every shard before the next starts, as JAX's
``shard_map`` program does between its collectives. On a mesh that
spans processes every rank builds the same model and runs the phases on
its own shards (every list of ``state`` None at the other positions):
the accumulate, the exchange and the migration send what crosses
between ranks as messages, and the diagnostics are collectives. Messages a step
and shard: 2 per mesh axis of more than one shard for each of the
accumulate, the exchange and the migration (18 on (2,2,2)). The JAX
model's PIC is plain XLA with no Pallas kernel; so is the port's: the
deposit is ``index_put_(accumulate=True)``, which the card runs with
atomic adds (CIC in float32 is therefore not bitwise from run to run
there; NGP of unit charges in float64 is exact in any order).

Boundaries are periodic. State per shard: ``rho`` (``dd.curr["rho"]``,
updated in place) and the particle SoA fields, ``valid`` and
``overflow`` in ``state``, each a list over the shards (x fastest).

Segments (``make_segment``, ``parallel/megastep.py``) carry the whole
state; their probe rows, like ``make_sentinel``'s probes, reduce rho and
the seven particle lanes with the per-shard cumulative overflow as an
extra column on the same reduction (its max over the shards).
``run_resilient`` runs them under the recovery driver, the particle
lanes riding each checkpoint, attributed by the performance observatory
against ``perf_model_step_seconds`` and ``perf_model_bytes_per_step``
(the two sweeps and the migration ring a step).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..distributed import DeviceLike, DistributedDomain, torch_dtype
from ..geometry import Dim3
from ..ops.stencil_kernels import central_diff
from ..parallel.exchange import (WireProbe, accumulate_shard,
                                 dispatch_exchange, shard_interior_len,
                                 shard_origin)
from ..parallel.methods import Method, pick_method
from ..parallel.migrate import (migrate_shard, migration_record_rows,
                                migration_wire_bytes_per_shard)
from ..utils.timers import device_sync

#: the particle SoA fields, in state order (one common dtype)
PARTICLE_FIELDS = ("x", "y", "z", "vx", "vy", "vz", "q")

#: every per-particle state key
PARTICLE_STATE_KEYS = PARTICLE_FIELDS + ("valid", "overflow")

#: PIC stencil radius: CIC deposits reach 1 cell past the interior and
#: the gathered E needs rho one cell further out
RADIUS = 2


def _floor_int(v: torch.Tensor) -> torch.Tensor:
    return torch.floor(v).to(torch.int32)


class Pic:
    """Distributed electrostatic-proxy PIC over a mesh of shards (one
    device by default: ``device=``; a mesh: ``mesh_shape=`` and
    ``devices=``). ``init=False`` skips the seeded host initial state
    (``init``), for a caller that installs particles itself
    (``set_shard_particles``)."""

    def __init__(self, x: int, y: int, z: int, n_particles: int,
                 mesh_shape=None, dtype=torch.float32,
                 devices: Optional[Sequence] = None,
                 methods: Method = Method.Default,
                 capacity: Optional[int] = None,
                 budget: Optional[int] = None,
                 deposition: str = "cic", dt: float = 0.25,
                 push: float = 1.0, seed: int = 0,
                 device: DeviceLike = None, init: bool = True) -> None:
        if deposition not in ("cic", "ngp"):
            raise ValueError(f"deposition must be cic|ngp, "
                             f"got {deposition!r}")
        self.dd = DistributedDomain(x, y, z, device=device, devices=devices)
        self.dd.set_radius(RADIUS)
        self.dd.set_methods(methods)
        if pick_method(methods) not in (Method.PpermuteSlab,
                                        Method.PpermutePacked):
            raise NotImplementedError(
                "Pic supports the PpermuteSlab and PpermutePacked "
                "exchange methods (the accumulate adjoint and the "
                "migration ring are copy engines)")
        if mesh_shape is not None:
            self.dd.set_mesh_shape(mesh_shape)
        self._dtype = torch_dtype(dtype)
        self.dd.add_data("rho", self._dtype)
        self.dd.realize()
        self.n_particles = int(n_particles)
        self.deposition = deposition
        self.dt = float(dt)
        self.push = float(push)
        self.seed = int(seed)
        counts = self.dd.mesh_counts
        n_shards = counts.flatten()
        per = -(-self.n_particles // n_shards)
        self.capacity = (int(capacity) if capacity is not None
                         else max(2 * per, 8))
        # the slot block per shard, for the ParticleLoss fault
        self.dd.particle_capacity = self.capacity
        if self.capacity < per:
            raise ValueError(
                f"capacity {self.capacity} < {per} particles/shard at "
                f"a uniform fill — even the initial state overflows")
        self.budget = (int(budget) if budget is not None
                       else max(self.capacity // 4, 4))
        if not 1 <= self.budget <= self.capacity:
            raise ValueError(f"budget must be in [1, capacity], got "
                             f"{self.budget}")
        local, rem = self.dd.local_size, self.dd.rem
        self._origins = []
        self._lens = []
        for i in range(n_shards):
            idx = self.dd.shard_index(i)
            self._origins.append(shard_origin(local, rem, idx))
            self._lens.append(tuple(shard_interior_len(a, local[a], rem,
                                                       idx[a])
                                    for a in range(3)))
        self._min_extent = min(local[a] - (1 if rem[a] else 0)
                               for a in range(3))
        #: the live state: ``rho`` (aliases ``dd.curr["rho"]``) and the
        #: particle lanes, each a list over the shards
        self.state: Dict[str, List[torch.Tensor]] = {
            "rho": self.dd.curr["rho"]}
        #: records every message between two mesh positions while set
        #: (a ``WireProbe``); None otherwise
        self.probe: Optional[WireProbe] = None
        self._probe_names = ["rho"] + list(PARTICLE_FIELDS)
        self._build_segment_builder()
        if init:
            self.init()

    # -- geometry helpers ----------------------------------------------
    def _axis_bounds(self, axis: int) -> np.ndarray:
        """Shard origins along grid ``axis`` and the grid's end (len
        counts + 1), uneven (+-1) partitions included."""
        counts, local, rem = (self.dd.mesh_counts, self.dd.local_size,
                              self.dd.rem)
        orgs = [shard_origin(local, rem,
                             Dim3(*(b if a == axis else 0
                                    for a in range(3))))[axis]
                for b in range(counts[axis])]
        return np.asarray(orgs + [self.dd.size[axis]], dtype=np.float64)

    # -- initial conditions --------------------------------------------
    def init(self) -> None:
        """Seeded uniform plasma (JAX ``Pic.init``): positions uniform
        over the grid, small thermal velocities, unit charges."""
        rng = np.random.default_rng(self.seed)
        g = self.dd.size
        n = self.n_particles
        arrays = {
            "x": rng.uniform(0, g.x, n), "y": rng.uniform(0, g.y, n),
            "z": rng.uniform(0, g.z, n),
            "vx": rng.normal(0, 0.05, n), "vy": rng.normal(0, 0.05, n),
            "vz": rng.normal(0, 0.05, n),
            "q": np.ones(n),
        }
        self.set_particles(arrays)

    def set_particles(self, arrays: Dict[str, np.ndarray]) -> None:
        """Install explicit particle ICs (host arrays of one common
        length, keys ``PARTICLE_FIELDS``; missing velocity/charge keys
        default to 0/1). Particles are binned to the shard owning their
        position and padded to the static capacity (JAX
        ``Pic.set_particles``)."""
        n = len(np.asarray(arrays["x"]))
        host = {}
        for k in PARTICLE_FIELDS:
            v = arrays.get(k)
            if v is None:
                v = np.ones(n) if k == "q" else np.zeros(n)
            host[k] = torch.from_numpy(np.asarray(v, dtype=np.float64)).to(
                self._dtype)
            if tuple(host[k].shape) != (n,):
                raise ValueError(f"particle field {k!r} has shape "
                                 f"{tuple(host[k].shape)}, want ({n},)")
        # bin by the values as stored (float64 holds every storage dtype)
        pos = {a: host[k].double().numpy()
               for a, k in enumerate(("x", "y", "z"))}
        for a in range(3):
            if np.any((pos[a] < 0) | (pos[a] >= self.dd.size[a])):
                raise ValueError(f"particle positions outside the "
                                 f"[0, {self.dd.size[a]}) grid along "
                                 f"{'xyz'[a]}")
        bidx = [np.searchsorted(self._axis_bounds(a), pos[a],
                                side="right") - 1 for a in range(3)]
        c = self.dd.mesh_counts
        block = (bidx[2] * c.y + bidx[1]) * c.x + bidx[0]
        per_shard = []
        for b in range(c.flatten()):
            sel = np.nonzero(block == b)[0]
            if len(sel) > self.capacity:
                raise ValueError(
                    f"{len(sel)} particles land on shard block {b} "
                    f"but capacity is {self.capacity}")
            sel = torch.from_numpy(sel)
            per_shard.append({k: host[k][sel] for k in PARTICLE_FIELDS})
        self.n_particles = n
        self.set_shard_particles(per_shard)

    def set_shard_particles(self, per_shard: Sequence[Dict[str,
                                                           torch.Tensor]]
                            ) -> None:
        """Install particles already binned: ``per_shard[i][k]`` the 1-D
        values of field k (``PARTICLE_FIELDS``) of the particles that
        shard i owns, on any device. Each shard's lanes are padded to
        the capacity (dead slots zero, ``valid`` False) on its device;
        the overflow counts restart at zero. On a mesh that spans
        processes only this rank's shards are installed (the other
        entries of ``per_shard`` may be None)."""
        devs = self.dd.mesh.devices
        if len(per_shard) != len(devs):
            raise ValueError(f"{len(per_shard)} shards of particles for "
                             f"{len(devs)} shards")
        own = set(self.dd.mesh.local_positions)
        lanes = {k: [] for k in PARTICLE_STATE_KEYS}
        for i, (parts, dev) in enumerate(zip(per_shard, devs)):
            if i not in own:
                for k in PARTICLE_STATE_KEYS:
                    lanes[k].append(None)
                continue
            m = int(parts["x"].shape[0])
            if m > self.capacity:
                raise ValueError(f"{m} particles on shard {i} but "
                                 f"capacity is {self.capacity}")
            for k in PARTICLE_FIELDS:
                t = torch.zeros(self.capacity, dtype=self._dtype,
                                device=dev)
                t[:m] = parts[k].to(dev, self._dtype)
                lanes[k].append(t)
            v = torch.zeros(self.capacity, dtype=torch.bool, device=dev)
            v[:m] = True
            lanes["valid"].append(v)
            lanes["overflow"].append(torch.zeros(1, dtype=torch.float32,
                                                 device=dev))
        self.state.update(lanes)

    def load_state(self, state: Dict[str, List[torch.Tensor]]) -> None:
        """Install a whole state, per shard: ``rho`` (padded, copied into
        ``dd.curr["rho"]``) and every key of ``PARTICLE_STATE_KEYS`` —
        for instance ``convert.pic_state_from_jax`` of a JAX model's, so
        that a JAX run continues here."""
        for dst, src in zip(self.state["rho"], state["rho"]):
            if dst is not None:
                dst.copy_(src)
        own = set(self.dd.mesh.local_positions)
        for k in PARTICLE_STATE_KEYS:
            want = (torch.bool if k == "valid" else torch.float32
                    if k == "overflow" else self._dtype)
            if any(state[k][i].dtype != want for i in own):
                raise TypeError(f"state[{k!r}] is not {want}")
            self.state[k] = [state[k][i].to(d) if i in own else None
                             for i, d in enumerate(self.dd.mesh.devices)]

    # -- the step --------------------------------------------------------
    def _weights(self, px, py, pz):
        """Per-corner ((cz, cy, cx), weight) of the deposition stencil in
        LOCAL cell coordinates, shared by the deposit and the gather."""
        if self.deposition == "ngp":
            return [((_floor_int(pz + 0.5), _floor_int(py + 0.5),
                      _floor_int(px + 0.5)), torch.ones_like(px))]
        i0 = (_floor_int(pz), _floor_int(py), _floor_int(px))
        f = (pz - torch.floor(pz), py - torch.floor(py),
             px - torch.floor(px))
        out = []
        for dz in (0, 1):
            wz = f[0] if dz else (1.0 - f[0])
            for dy in (0, 1):
                wy = f[1] if dy else (1.0 - f[1])
                for dx in (0, 1):
                    wx = f[2] if dx else (1.0 - f[2])
                    out.append(((i0[0] + dz, i0[1] + dy, i0[2] + dx),
                                wz * wy * wx))
        return out

    def _deposit(self, i: int, corners) -> None:
        """Scatter shard i's charges into its padded rho, pads included,
        by ``index_add_`` (atomic adds on the card); dead slots and cells
        off the allocation add zero to cell 0 instead (JAX drops them),
        so no data-dependent shape forces a device-to-host sync."""
        rho = self.state["rho"][i]
        lo = self.dd.alloc_radius.pad_lo()
        valid, q = self.state["valid"][i], self.state["q"][i]
        zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
        rho.copy_(torch.nan_to_num(rho) * zero)
        Zp, Yp, Xp = rho.shape
        flat = rho.view(-1)
        for (cz, cy, cx), w in corners:
            iz, iy, ix = cz + lo.z, cy + lo.y, cx + lo.x
            keep = (valid & (iz >= 0) & (iz < Zp) & (iy >= 0) & (iy < Yp)
                    & (ix >= 0) & (ix < Xp))
            cell = (iz.long() * Yp + iy) * Xp + ix
            flat.index_add_(0, torch.where(keep, cell, 0),
                            torch.where(keep, q * w, zero))

    def _gather(self, i: int, corners):
        """E = -grad rho at shard i's particles: the field on the static
        [0, capacity] node window, interpolated with the deposit's
        weights."""
        rho = self.state["rho"][i]
        local = self.dd.local_size
        win = Dim3(local.x + 1, local.y + 1, local.z + 1)
        E = [-central_diff(rho, a, self.dd.alloc_radius, win)
             for a in range(3)]
        px = self.state["x"][i]
        ex, ey, ez = (torch.zeros_like(px) for _ in range(3))
        for (cz, cy, cx), w in corners:
            g = (torch.clamp(cz, 0, local.z).long(),
                 torch.clamp(cy, 0, local.y).long(),
                 torch.clamp(cx, 0, local.x).long())
            ex = ex + w * E[0][g]
            ey = ey + w * E[1][g]
            ez = ez + w * E[2][g]
        return ex, ey, ez

    def _push(self, i: int, e):
        """The leapfrog push of shard i, its per-axis hops and CFL guard:
        (new fields, valid, offsets, CFL drops)."""
        st = {k: self.state[k][i] for k in PARTICLE_STATE_KEYS}
        valid, q = st["valid"], st["q"]
        o, ln, g = self._origins[i], self._lens[i], self.dd.size
        k = torch.full((), self.push * self.dt, dtype=q.dtype,
                       device=q.device)
        v = [st[n] + k * q * e[a] for a, n in enumerate(("vx", "vy", "vz"))]
        u = [st[n] + v[a] * self.dt for a, n in enumerate(("x", "y", "z"))]
        offs = tuple(torch.where(valid, (u[a] >= o[a] + ln[a]).to(torch.int32)
                                 - (u[a] < o[a]).to(torch.int32), 0)
                     for a in range(3))
        cfl = valid & ((u[0] >= o[0] + 2 * ln[0]) | (u[0] < o[0] - ln[0])
                       | (u[1] >= o[1] + 2 * ln[1]) | (u[1] < o[1] - ln[1])
                       | (u[2] >= o[2] + 2 * ln[2]) | (u[2] < o[2] - ln[2]))
        fields = {"x": torch.remainder(u[0], g.x),
                  "y": torch.remainder(u[1], g.y),
                  "z": torch.remainder(u[2], g.z),
                  "vx": v[0], "vy": v[1], "vz": v[2], "q": q}
        return fields, valid & ~cfl, offs, cfl

    def _corners(self, i: int):
        """Shard i's deposition stencil at its particles' local
        coordinates (recomputed for the gather rather than held: at tens
        of millions of particles a shard it is gigabytes)."""
        o = self._origins[i]
        return self._weights(self.state["x"][i] - o[0],
                             self.state["y"][i] - o[1],
                             self.state["z"][i] - o[2])

    def step(self) -> None:
        """One PIC step: deposit, accumulate, exchange, gather, push,
        migrate."""
        dd = self.dd
        n = dd.mesh_counts.flatten()
        counts, rem = dd.mesh_counts, dd.rem
        ranks = dd.mesh.peers
        own = dd.mesh.local_positions
        for i in own:
            self._deposit(i, self._corners(i))
        accumulate_shard(self.state["rho"], dd.alloc_radius, counts,
                         rem=rem, probe=self.probe, ranks=ranks)
        dispatch_exchange({"rho": self.state["rho"]}, dd.alloc_radius,
                          counts, pick_method(dd.methods), rem=rem,
                          probe=self.probe, ranks=ranks)
        new = {k: [None] * n for k in PARTICLE_FIELDS}
        valid, offs, cfl = [None] * n, [None] * n, [None] * n
        for i in own:
            f, valid[i], offs[i], cfl[i] = self._push(
                i, self._gather(i, self._corners(i)))
            for k in PARTICLE_FIELDS:
                new[k][i] = f[k]
        fields, valid, ovf = migrate_shard(new, valid, offs, counts,
                                           self.budget, probe=self.probe,
                                           ranks=ranks)
        for k in PARTICLE_FIELDS:
            self.state[k] = fields[k]
        self.state["valid"] = valid
        self.state["overflow"] = [
            None if prev is None else prev + (o + c.sum().to(torch.float32))
            for prev, o, c in zip(self.state["overflow"], ovf, cfl)]

    def run(self, iters: int) -> None:
        """``iters`` steps."""
        for _ in range(int(iters)):
            self.step()

    # -- megastep: campaign segments -------------------------------------
    def _probe_extra(self, st) -> Dict[str, List[torch.Tensor]]:
        """The overflow column: each shard's cumulative drop count."""
        return {"migration_overflow": [None if o is None else o[0]
                                       for o in st["overflow"]]}

    def segment_contract(self):
        """The PIC carry contract (``parallel/megastep.py``): the whole
        state — the padded rho, every particle lane, ``valid`` and the
        overflow counts —, probe rows over rho and the seven lanes with
        the cumulative migration-overflow count as an extra column on
        the same reduction (the column layout ``make_sentinel``'s
        ``extra_names`` decode)."""
        from ..parallel.megastep import CarryContract

        return CarryContract(
            probe_view=lambda st: {q: st[q] for q in self._probe_names},
            probe_extra=self._probe_extra)

    def _adopt(self, out) -> None:
        self.state = out
        self.dd.curr["rho"] = self.state["rho"]

    def _build_segment_builder(self) -> None:
        from ..parallel.megastep import SegmentCompiler

        def advance(st, c, i):
            self.run(c)
            return self.state

        self._segment_builder = SegmentCompiler(
            self.dd.mesh, self.segment_contract(), advance,
            lambda: self.state, self._adopt,
            # the sentinel decodes PIC's own overflow column; telemetry
            # columns would shift it, so the rows keep the contract's
            # columns whatever ``metrics`` is
            use_metrics=False)

    def make_segment(self, check_every: int, probe_every: int = 1,
                     metrics=None):
        """A ``Segment`` advancing ``check_every`` PIC steps (deposit,
        accumulate, exchange, gather, push, migrate), with the health
        probe (rho, the particle lanes and the overflow column) on the
        device every ``probe_every`` steps. ``metrics`` is accepted for
        the drivers' interface and ignored (see ``segment_contract``)."""
        return self._segment_builder(int(check_every),
                                     max(int(probe_every), 1), metrics)

    def make_sentinel(self, window: int = 8, growth_factor: float = 1e6):
        """A ``resilience.health.HealthSentinel`` over the live state (rho
        and every particle lane), the overflow column riding the probe's
        reduction (``HealthStats.metrics['migration_overflow']``). The
        reduction is a max, so the column is the WORST shard's cumulative
        drop count; ``overflow_total()`` is the sum."""
        from ..resilience.health import HealthSentinel, probe_mesh

        names = self._probe_names
        return HealthSentinel(
            self.dd, window=window, growth_factor=growth_factor,
            names=names,
            probe_fn=lambda st, step: probe_mesh(
                {q: st[q] for q in names}, self.dd.mesh,
                self._probe_extra(st)),
            extra_names=("migration_overflow",))

    def block(self) -> None:
        device_sync([t for t in self.state["rho"] + self.state["x"]
                     if t is not None])

    # -- diagnostics ----------------------------------------------------
    def rho(self) -> np.ndarray:
        """Global interior charge density (z,y,x) on the host."""
        return self.dd.interior_to_host("rho")

    def _per_shard(self, value) -> List[float]:
        """``value(i)`` (a float) of every shard, in position order: on a
        mesh that spans processes each rank fills its own, and one
        all-reduce (a sum, into zeros) hands every rank all of them, so
        the totals are the same bits on every rank and in one process."""
        n = self.dd.mesh_counts.flatten()
        got = [0.0] * n
        for i in self.dd.mesh.local_positions:
            got[i] = float(value(i))
        if self.dd.mesh.spans_ranks:
            import torch.distributed as dist

            from ..parallel.multihost import backend

            dev = (self.dd.mesh.devices[self.dd.mesh.local_positions[0]]
                   if backend() == "nccl" else "cpu")
            t = torch.tensor(got, dtype=torch.float64, device=dev)
            dist.all_reduce(t)
            got = t.tolist()
        return got

    def total_charge(self) -> float:
        """Sum of the deposited charge over the global grid: the model
        dtype's ``np.sum`` of ``rho()``, as JAX's ``Pic.total_charge``
        (a collective on a mesh that spans processes; every rank gets
        the same value)."""
        r = self.rho()
        return float(np.sum(r, dtype=r.dtype))

    def particles_to_host(self) -> Dict[str, np.ndarray]:
        """Host copies of the live particles only (shard by shard, slot
        by slot), plus the per-shard overflow counts under
        ``'overflow'`` (a collective on a mesh that spans processes:
        every rank gets every shard's)."""
        per = {}
        for i in self.dd.mesh.local_positions:
            v = self.state["valid"][i].cpu()
            per[i] = {k: self.state[k][i].cpu()[v].numpy()
                      for k in PARTICLE_FIELDS}
            per[i]["overflow"] = self.state["overflow"][i].cpu().numpy()
        if self.dd.mesh.spans_ranks:
            from ..parallel.multihost import all_gather_objects

            for got in all_gather_objects(per):
                per.update(got)
        order = sorted(per)
        return {k: np.concatenate([per[i][k] for i in order])
                for k in PARTICLE_FIELDS + ("overflow",)}

    def overflow_total(self) -> float:
        """Particles dropped by migration so far (all shards; a
        collective on a mesh that spans processes)."""
        return float(sum(self._per_shard(
            lambda i: self.state["overflow"][i].sum())))

    def migration_stats(self) -> dict:
        """The migration's wire cost and the CFL displacement bound (JAX
        ``Pic.migration_stats``)."""
        counts = self.dd.mesh_counts
        isz = torch.empty((), dtype=self._dtype).element_size()
        return {
            "capacity": self.capacity, "budget": self.budget,
            "record_bytes": migration_record_rows(len(PARTICLE_FIELDS))
            * isz,
            "migration_bytes_per_shard": migration_wire_bytes_per_shard(
                len(PARTICLE_FIELDS), self.budget, counts, isz),
            "max_displacement_per_step": float(self._min_extent),
        }

    # -- checkpointing / resilience ---------------------------------------
    def _particle_extras(self) -> Dict[str, List[torch.Tensor]]:
        return {k: self.state[k] for k in PARTICLE_STATE_KEYS}

    def _install_particles(self, extras: Dict[str, list]) -> None:
        for k in PARTICLE_STATE_KEYS:
            if k not in extras:
                raise ValueError(f"checkpoint extras missing particle "
                                 f"lane {k!r}")
            want = (torch.bool if k == "valid" else torch.float32
                    if k == "overflow" else self._dtype)
            self.state[k] = [None if t is None else t.to(want)
                             for t in extras[k]]

    def run_resilient(self, n_steps: int, policy=None,
                      ckpt_dir: Optional[str] = None, faults=None):
        """``n_steps`` PIC steps under the checkpoint-rollback driver
        (JAX ``models/pic.py:575``): the particle lanes, ``valid`` and
        the overflow counts ride every checkpoint as extras, the sentinel
        (``make_sentinel``) probes the whole live state with the overflow
        column on its one reduction, and a recovered run equals the
        fault-free one. Exports ``stencil_run_particles_total`` and
        ``stencil_run_migration_overflow_total``."""
        from ..resilience.driver import run_resilient

        ovf0 = self.overflow_total()

        def on_restore(extras):
            # restore_domain already reinstalled rho into dd.curr
            self.state["rho"] = self.dd.curr["rho"]
            self._install_particles(extras)

        report = run_resilient(
            self.dd, self.step, n_steps, policy=policy,
            ckpt_dir=ckpt_dir, faults=faults,
            extra_fn=self._particle_extras, on_restore=on_restore,
            fields_fn=lambda: self.state,
            make_segment=self.make_segment,
            sentinel_factory=lambda dd: self.make_sentinel(),
            model_step_seconds=self.perf_model_step_seconds(),
            model_bytes_per_step=self.perf_model_bytes_per_step(),
            perf_entry="pic")
        self._export_run_metrics(report.steps, ovf0)
        return report

    def _export_run_metrics(self, steps: int, ovf0: float = 0.0) -> None:
        """Process-registry telemetry: particle steps advanced and
        migration-overflow drops (JAX's metric names)."""
        from ..telemetry import get_registry
        reg = get_registry()
        c = reg.counter(
            "stencil_run_particles_total",
            "particle steps advanced by PIC run loops (one count per "
            "particle per step; replayed rollback windows included)")
        c.inc(max(int(steps), 0) * self.n_particles)
        o = reg.counter(
            "stencil_run_migration_overflow_total",
            "particles dropped by fixed-capacity migration (send "
            "budget or receive capacity exceeded) — nonzero means the "
            "capacity/budget plan is undersized for the flux")
        o.inc(max(self.overflow_total() - ovf0, 0.0))

    # -- the performance observatory's price of a step ---------------------
    def perf_model_step_seconds(self) -> Optional[float]:
        """The cost model's wire seconds per STEP (JAX ``models/pic.py:
        509-529``): the reverse halo-accumulate and the forward exchange
        (two radius-2 sweeps) priced by the exchange model, plus the
        migration ring (``analysis/costmodel.migration_step_seconds``).
        None on a one-shard mesh."""
        from ..analysis.costmodel import migration_step_seconds
        from ..observatory.attribution import model_step_seconds_for

        sweep = model_step_seconds_for(self.dd)
        if sweep is None:
            return None
        mig = migration_step_seconds(len(PARTICLE_FIELDS), self.budget,
                                     self.dd.mesh_counts,
                                     self._dtype.itemsize)
        total = 2.0 * sweep + mig
        return total if total > 0 else None

    def perf_model_bytes_per_step(self) -> float:
        """Whole-mesh modeled wire B/step: two sweeps and the migration
        ring on every shard (JAX ``models/pic.py:531-541``)."""
        n_shards = self.dd.mesh_counts.flatten()
        mig = self.migration_stats()["migration_bytes_per_shard"]
        return (2.0 * float(self.dd.exchange_bytes_amortized_per_step())
                + mig * n_shards)


def dense_reference_rho(x, y, z, q, gsize, dtype=np.float64,
                        deposition: str = "cic") -> np.ndarray:
    """Single-host dense oracle of one deposition over the periodic
    global grid (a copy of the JAX package's): the reference for deposit
    + reverse halo-accumulate on any mesh."""
    g = Dim3.of(gsize)
    rho = np.zeros((g.z, g.y, g.x), dtype=dtype)
    x = np.asarray(x, dtype=dtype)
    y = np.asarray(y, dtype=dtype)
    z = np.asarray(z, dtype=dtype)
    q = np.asarray(q, dtype=dtype)
    if deposition == "ngp":
        cx = np.floor(x + 0.5).astype(int) % g.x
        cy = np.floor(y + 0.5).astype(int) % g.y
        cz = np.floor(z + 0.5).astype(int) % g.z
        np.add.at(rho, (cz, cy, cx), q)
        return rho
    i0x, fx = np.floor(x).astype(int), x - np.floor(x)
    i0y, fy = np.floor(y).astype(int), y - np.floor(y)
    i0z, fz = np.floor(z).astype(int), z - np.floor(z)
    for dz in (0, 1):
        wz = fz if dz else (1.0 - fz)
        for dy in (0, 1):
            wy = fy if dy else (1.0 - fy)
            for dx in (0, 1):
                wx = fx if dx else (1.0 - fx)
                np.add.at(rho, ((i0z + dz) % g.z, (i0y + dy) % g.y,
                                (i0x + dx) % g.x), q * wz * wy * wx)
    return rho
