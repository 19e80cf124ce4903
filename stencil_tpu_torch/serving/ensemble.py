"""Batched ensembles: one dispatch advances N independent runs.

PyTorch-port counterpart of ``stencil_tpu/serving/ensemble.py``. The
member axis is a leading dimension of every shard: each quantity is one
``(n_members, Zp, Yp, Xp)`` tensor per mesh position, on that
position's device, and every op of a step broadcasts over it — the
counterpart of JAX's ``jax.vmap`` over the shard step (a Python loop
over the members would multiply the launches by N instead):

* the plain stencil math (``ops/stencil_kernels.py``, ``ops/fd6.py``,
  ``models/astaroth.mhd_rates``) indexes ``[..., z, y, x]``;
* the exchange (``parallel/exchange.py``) cuts every box by dimensions
  counted from the end, so each direction is ONE message carrying N
  slabs — the same message count as one member, exactly N x the wire
  bytes; ``Method.PallasDMA`` sweeps the N member views of each shard
  as N more rows of B4's one launch table (``ops/cuda_exchange.
  member_views``), one launch per card and sweep whatever N is;
* the health probe reduces each member over its last three dimensions
  (``resilience/health.probe_shard``): one ``(n_members, 2, n_q)`` row
  per shard, then one ``amax`` across the mesh.

Per-member parameters (Jacobi hot/cold Dirichlet temperatures, MHD
physics coefficients) are ``(n_members, 1, 1, 1)`` tensors on each
shard's device, uploaded when they change (never inside a dispatch).
The MHD coefficients are held in float64 and rounded to the compute
dtype where ``mhd_rates`` uses them (``fd6.const``), as the standalone
model rounds its Python floats, so a member equals the standalone
``Astaroth`` with its coefficients bit for bit.

Health is per member: :class:`EnsembleSentinel` evaluates the
divergence predicate per member, so one member's NaN trips only that
member. Member checkpoints store each member's GLOBAL interiors
(``utils/checkpoint.save_arrays``), which do not depend on the mesh: a
member saved on one mesh restores on another, and a fleet moves
campaigns between replicas through them.

An ensemble runs in one process (as JAX's runs under one controller):
a device list that spans ranks raises.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed import DistributedDomain, torch_dtype
from ..geometry import Radius
from ..local_domain import interior_slices, raw_size, zyx_shape
from ..parallel.exchange import dispatch_exchange
from ..parallel.mesh import as_global, this_rank
from ..parallel.methods import Method, pick_method
from ..resilience.health import (ROW_MAX_ABS, ROW_NONFINITE, HealthStats,
                                 _to_host, probe_mesh)
from ..topology import Boundary
from ..utils.checkpoint import CorruptCheckpointError, restore_arrays, \
    save_arrays
from ..utils.logging import LOG_INFO


# ---------------------------------------------------------------------------
# problem identity (shared by queue admission and engine construction)


def storage_dtype(dtype) -> torch.dtype:
    """A request's dtype (``"float32"``, ``"float64"``, ``"bfloat16"``,
    or a torch/numpy dtype) as a torch dtype."""
    if isinstance(dtype, str):
        got = getattr(torch, dtype, None)
        if not isinstance(got, torch.dtype):
            raise ValueError(f"unknown dtype {dtype!r}")
        return got
    return torch_dtype(dtype)


def configured_domain(model: str, grid: Sequence[int], dtype=torch.float32,
                      methods: Method = Method.Default, boundary=None,
                      mesh_shape=None, devices=None) -> DistributedDomain:
    """A configured (NOT realized) domain for ``model`` — the single
    source of the quantity set / radius / mesh choice, so the queue's
    admission fingerprint and the engine can never disagree about
    problem identity. ``devices`` None: every visible card."""
    x, y, z = (int(v) for v in grid)
    dd = DistributedDomain(x, y, z, devices=devices)
    dtype = storage_dtype(dtype)
    if model == "jacobi":
        dd.set_radius(1)
        dd.add_data("temp", dtype)
    elif model == "astaroth":
        from ..models.astaroth import FIELDS
        from ..ops.fd6 import RADIUS
        dd.set_radius(Radius.constant(RADIUS))
        for q in FIELDS:
            dd.add_data(q, dtype)
    else:
        raise ValueError(f"unknown ensemble model {model!r} "
                         f"(jacobi|astaroth)")
    dd.set_methods(methods)
    if boundary is not None:
        dd.set_boundary(boundary)
    if mesh_shape is not None:
        dd.set_mesh_shape(mesh_shape)
    return dd


def request_domain(req, devices=None) -> DistributedDomain:
    """``configured_domain`` of a ``queue.CampaignRequest``."""
    return configured_domain(req.model, req.grid,
                             dtype=storage_dtype(req.dtype),
                             boundary=Boundary[req.boundary],
                             mesh_shape=req.mesh_shape, devices=devices)


def domain_fingerprint(dd: DistributedDomain) -> str:
    """The :mod:`..tuning` problem fingerprint of a configured domain —
    the admission key: requests sharing it share an ensemble engine AND
    a cached exchange plan."""
    from ..tuning import fingerprint, inputs_from_domain
    return fingerprint(inputs_from_domain(dd, dd._choose_partition_dim()))


def spans_ranks(devices) -> bool:
    """True when ``devices`` (None: this process's default) names a
    device of another process, or defaults to a mesh over processes."""
    if devices is None:
        from ..parallel.multihost import process_count
        return process_count() > 1
    me = this_rank()
    return any(as_global(d).rank != me for d in devices)


# ---------------------------------------------------------------------------
# per-member health


def make_ensemble_probe(mesh, names: Sequence[str]):
    """The per-member probe: ``fn(batched_fields) -> (n_members, 2,
    len(names))`` float32 stats on the first shard's device, one
    ``amax`` across the mesh (JAX's vmapped ``probe_shard``, one
    all-reduce)."""
    names = list(names)

    def fn(fields):
        return probe_mesh({q: fields[q] for q in names}, mesh)

    return fn


@dataclasses.dataclass
class EnsembleHealth:
    """One harvested per-member probe: ``members[k]`` is member k's
    :class:`~..resilience.health.HealthStats` at ``step``."""

    step: int
    members: List[HealthStats]

    @property
    def tripped_members(self) -> List[int]:
        return [k for k, s in enumerate(self.members) if s.tripped]


class EnsembleSentinel:
    """Per-member watchdog over an ensemble engine: ``probe(step)``
    queues the batched reduction and its copy to pinned host memory
    (async), ``poll()`` harvests ready results (``Event.query()``) and
    evaluates the divergence predicate independently per member — a NaN
    in member k trips member k and nobody else. ``reset_member(k)``
    forgets k's history after the service rolls that campaign back."""

    def __init__(self, engine, window: int = 8,
                 growth_factor: float = 1e6) -> None:
        self.engine = engine
        self.names = list(engine.dd._names)
        self.window = int(window)
        self.growth_factor = float(growth_factor)
        self._pending: Deque = deque()
        self._history: List[Dict[str, Deque[float]]] = [
            {q: deque(maxlen=self.window) for q in self.names}
            for _ in range(engine.n_members)]

    def probe(self, step: int) -> None:
        self._pending.append(
            _to_host(step, self.engine._probe_fn(dict(self.engine.state))))

    def observe_segment(self, trace, steps) -> None:
        """Queue a segment's per-member probe trace (``run_segment``):
        row ``j`` is the batched probe of member step ``steps[j]``;
        ``poll`` expands the rows oldest first."""
        self._pending.append(_to_host(tuple(int(s) for s in steps),
                                      getattr(trace, "array", trace)))

    def poll(self, block: bool = False) -> List[EnsembleHealth]:
        out: List[EnsembleHealth] = []
        while self._pending:
            e = self._pending[0]
            if e.event is not None:
                if not block and not e.event.query():
                    break
                e.event.synchronize()
            self._pending.popleft()
            host = e.host.numpy()
            if isinstance(e.step, tuple):
                for j, s in enumerate(e.step):
                    out.append(self._evaluate(s, host[j]))
            else:
                out.append(self._evaluate(e.step, host))
        return out

    def reset_member(self, k: int) -> None:
        for h in self._history[k].values():
            h.clear()

    def reset(self) -> None:
        self._pending.clear()
        for k in range(len(self._history)):
            self.reset_member(k)

    def _evaluate(self, step: int, host: np.ndarray) -> EnsembleHealth:
        members: List[HealthStats] = []
        for k in range(host.shape[0]):
            nonfinite = {q: int(host[k, ROW_NONFINITE, i])
                         for i, q in enumerate(self.names)}
            max_abs = {q: float(host[k, ROW_MAX_ABS, i])
                       for i, q in enumerate(self.names)}
            stats = HealthStats(step, nonfinite, max_abs)
            bad = [q for q, n in nonfinite.items() if n > 0]
            if bad:
                stats.tripped = True
                stats.reason = (f"member {k}: non-finite cells in {bad} "
                                f"({ {q: nonfinite[q] for q in bad} })")
            else:
                grown = []
                for q in self.names:
                    hist = self._history[k][q]
                    if hist:
                        baseline = min(hist)
                        if baseline > 0 and \
                                max_abs[q] > self.growth_factor * baseline:
                            grown.append(q)
                if grown:
                    stats.tripped = True
                    stats.reason = (f"member {k}: max-abs grew more "
                                    f"than x{self.growth_factor:g} "
                                    f"over the window for {grown}")
                else:
                    for q in self.names:
                        self._history[k][q].append(max_abs[q])
            members.append(stats)
        return EnsembleHealth(step, members)


# ---------------------------------------------------------------------------
# the engines


def _host_values(values, dtype: torch.dtype) -> torch.Tensor:
    """A host array (or tensor) as a CPU tensor of ``dtype``, rounded as
    the JAX engine's ``np.asarray(values, dtype)`` rounds: numpy for
    float32 and float64, bfloat16 through float32."""
    if isinstance(values, torch.Tensor):
        return values.detach().to("cpu", dtype)
    a = np.asarray(values)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(
        a.astype(torch.empty((), dtype=dtype).numpy().dtype)))


def _upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``host`` on ``device``: through pinned memory, non-blocking, on a
    card (nothing waits for it), as it is on the CPU."""
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


class _EnsembleBase:
    """Shared machinery of the batched engines: the domain, the batched
    state, lane get/set, per-member parameters, snapshots, and
    per-member checkpoint save/restore."""

    MODEL = ""
    #: per-member runtime parameters, in the order the step consumes
    PARAM_NAMES: Tuple[str, ...] = ()

    def __init__(self, n_members: int, x: int, y: int, z: int,
                 dtype=torch.float32, devices=None,
                 methods: Method = Method.Default, boundary=None,
                 mesh_shape=None, plan=None) -> None:
        if int(n_members) < 1:
            raise ValueError(f"n_members must be >= 1, got {n_members}")
        if spans_ranks(devices):
            raise NotImplementedError(
                "an ensemble runs in one process (the JAX package's "
                "under one controller): its devices must not span ranks")
        self.n_members = int(n_members)
        self.dd = configured_domain(self.MODEL, (x, y, z), dtype=dtype,
                                    methods=methods, boundary=boundary,
                                    mesh_shape=mesh_shape,
                                    devices=devices)
        #: the admission/plan-cache key (computed pre-realize)
        self.fingerprint = domain_fingerprint(self.dd)
        if plan is not None:
            # adopt the plan's transport; temporal blocking depths are
            # a single-run optimization the batched step does not take
            self.dd.set_methods(Method[plan.config.method])
            if plan.config.exchange_every != 1:
                LOG_INFO(f"ensemble engine ignores plan depth "
                         f"s={plan.config.exchange_every} (batched "
                         f"steps exchange every step)")
            self.dd.plan = plan
        self.dd.realize()
        dd = self.dd
        self._dtype = dd._dtypes[dd._names[0]]
        self.names: List[str] = list(dd._names)
        self.devices: List[torch.device] = list(dd.mesh.devices)
        self._method = pick_method(dd.methods)
        self._nonper = dd.boundary == Boundary.NONE
        #: one padded shard of one member (capacity-sized)
        self._lane_shape = zyx_shape(raw_size(dd.local_size,
                                              dd.alloc_radius))
        #: batched padded fields: name -> one (n_members, Zp, Yp, Xp)
        #: tensor per mesh position (x fastest)
        self.state: Dict[str, List[torch.Tensor]] = {
            q: self._zeros_batched(self._lane_shape) for q in self.names}
        self._params: Dict[str, np.ndarray] = {
            p: np.full(self.n_members, v, dtype=np.float64)
            for p, v in self.default_params().items()}
        self._probe_fn = make_ensemble_probe(dd.mesh, self.names)
        self._segments: Dict = {}
        # one stable object (a bound method is a new one per access)
        self._step_program = self._advance
        self._build_step()
        self._upload_params()

    # -- subclass contract ---------------------------------------------
    #: the dtype the per-member parameter tensors are held in (None:
    #: the field dtype)
    PARAM_DTYPE: Optional[torch.dtype] = None

    def default_params(self) -> Dict[str, float]:
        raise NotImplementedError

    def _build_step(self) -> None:
        """Allocate what the step keeps besides the fields."""

    def _advance(self, n: int) -> None:
        """Advance every member ``n`` steps in place."""
        raise NotImplementedError

    def _params_changed(self) -> None:
        """Rebuild what the step derives from the parameter tensors."""

    def run(self, n_steps: int) -> None:
        """Advance ALL members ``n_steps`` steps (every op over the
        whole batch)."""
        self._advance(int(n_steps))

    def run_segment(self, n_steps: int, probe_every: int = 1):
        """Advance ALL members ``n_steps`` steps with the per-member
        health probe on the device every ``probe_every`` steps (and at
        the last): the port's megastep (``parallel/megastep.py``),
        whose :class:`~..parallel.megastep.SegmentTrace` stacks one
        ``(n_members, 2, n_quantities)`` row per probe. Nothing in it
        waits for the card."""
        from ..parallel.megastep import (SegmentTrace, fused_segment_shard,
                                         probe_rel_steps, segment_chunks)
        k = int(n_steps)
        probe_every = max(int(probe_every), 1)
        chunks = segment_chunks(k)
        fn = self._segments.get((k, probe_every))
        if fn is None:
            def fn(state, k=k, pe=probe_every):
                def advance(st, c, idx):
                    self._advance(c)
                    return st

                return fused_segment_shard(
                    state, advance, lambda st, done: self._probe_fn(st),
                    chunks, pe)
            self._segments[(k, probe_every)] = fn
        _, trace = fn(self.state)
        return SegmentTrace(trace, probe_rel_steps(chunks, probe_every))

    # -- allocation / lane plumbing ------------------------------------
    def _zeros_batched(self, shape) -> List[torch.Tensor]:
        return [torch.zeros((self.n_members,) + tuple(shape),
                            dtype=self._dtype, device=d)
                for d in self.devices]

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the live state (the attribution fence)."""
        return [t for v in self.state.values() for t in v]

    def _shard_block(self, i: int) -> Tuple[slice, slice, slice]:
        """Shard ``i``'s live interior slices in its padded lane."""
        return interior_slices(self.dd.shard_size(i), self.dd.alloc_radius)

    def _global_slices(self, i: int) -> Tuple[slice, slice, slice]:
        sz, org = self.dd.shard_size(i), self.dd.shard_origin(i)
        return (slice(org.z, org.z + sz.z), slice(org.y, org.y + sz.y),
                slice(org.x, org.x + sz.x))

    def _upload_params(self) -> None:
        """The per-member parameters as ``(n_members, 1, 1, 1)`` tensors
        on every device of the mesh (one upload per device)."""
        dt = self.PARAM_DTYPE or self._dtype
        per_dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        for d in dict.fromkeys(self.devices):
            per_dev[d] = {
                p: _upload(_host_values(
                    self._params[p].reshape(-1, 1, 1, 1), dt), d)
                for p in self.PARAM_NAMES}
        #: per mesh position: {param: (n_members, 1, 1, 1) tensor}
        self._param_dev = [per_dev[d] for d in self.devices]
        self._params_changed()

    def jit_entry_points(self) -> Dict[str, object]:
        """The hot-path programs a recompile watchdog
        (:class:`~..analysis.recompile.SingleCompileGuard`) observes
        after each dispatch: the step loop and every built segment."""
        out: Dict[str, object] = {"step_n": self._step_program}
        for (k, p), fn in self._segments.items():
            out[f"segment[k={k},probe_every={p}]"] = fn
        return out

    # -- per-member parameters -----------------------------------------
    def set_member_params(self, k: int, overrides: Dict[str, float]
                          ) -> None:
        for name, v in overrides.items():
            if name not in self._params:
                raise KeyError(
                    f"unknown ensemble parameter {name!r} for "
                    f"{self.MODEL} (have {sorted(self._params)})")
            self._params[name][k] = float(v)
        self._upload_params()

    def member_params(self, k: int) -> Dict[str, float]:
        return {p: float(a[k]) for p, a in self._params.items()}

    # -- member state access -------------------------------------------
    def _set_lanes(self, batched: List[torch.Tensor], k: int, values,
                   block) -> None:
        """Write a global (z,y,x) array into lane ``k`` of per-shard
        batched tensors, at each shard's ``block(i)`` slices, zeroing
        the rest of the lane (halos, a short shard's dead row)."""
        host = _host_values(values, self._dtype)
        if tuple(host.shape) != zyx_shape(self.dd.size):
            raise ValueError(f"interior shape {tuple(host.shape)} != "
                             f"{zyx_shape(self.dd.size)}")
        for i, t in enumerate(batched):
            lane = t[k]
            lane.zero_()
            lane[block(i)].copy_(host[self._global_slices(i)])

    def set_member_interior(self, name: str, k: int, values) -> None:
        """Scatter a global (z,y,x) interior into member ``k``'s lane of
        quantity ``name`` (initial conditions / restore), in place."""
        self._set_lanes(self.state[name], k, values, self._shard_block)

    def _gather_lane(self, batched: List[torch.Tensor], k: int,
                     block) -> np.ndarray:
        return self.dd.gather_blocks([t[k][block(i)]
                                      for i, t in enumerate(batched)])

    def member_interior(self, name: str, k: int) -> np.ndarray:
        """Member ``k``'s global interior of ``name`` on host
        (blocking; bfloat16 as float32 of its values)."""
        return self._gather_lane(self.state[name], k, self._shard_block)

    def member_interiors(self, k: int) -> Dict[str, np.ndarray]:
        """All of member ``k``'s global interiors on host."""
        return {q: self.member_interior(q, k) for q in self.names}

    def member_snapshot_async(self, k: int, step: int
                              ) -> "EnsembleSnapshot":
        """Queue a snapshot of member ``k``: each shard's lane interior
        is copied into pinned host memory on its device's stream, an
        event after it; poll :meth:`EnsembleSnapshot.ready` and call
        :meth:`~EnsembleSnapshot.get` once true — the step pipeline is
        never stalled by readback."""
        def lane(t, i):
            v = t[k][self._shard_block(i)]
            # a CPU copy now (on a card, the queued copy is the snapshot)
            return _to_host(step, v if v.is_cuda else v.clone())

        lanes = {q: [lane(t, i) for i, t in enumerate(self.state[q])]
                 for q in self.names}
        return EnsembleSnapshot(self, k, step, lanes)

    def reset_member(self, k: int) -> None:
        """Benign (zero) state + default parameters for lane ``k`` —
        idle lanes of a partially-filled service batch, and poisoned
        lanes of failed campaigns, must not trip the sentinel."""
        for q in self.names:
            for t in self.state[q]:
                t[k].zero_()
        for p, v in self.default_params().items():
            self._params[p][k] = v
        self._upload_params()

    # -- per-member checkpoints ----------------------------------------
    def _member_extra_arrays(self, k: int) -> Dict[str, np.ndarray]:
        """Model-specific auxiliary state to checkpoint with a lane
        (the Astaroth RK accumulator)."""
        return {}

    def _restore_member_extras(self, k: int,
                               extras: Dict[str, np.ndarray]) -> None:
        pass

    def save_member(self, directory: str, step: int, k: int,
                    meta_extra: Optional[Dict] = None,
                    max_to_keep: Optional[int] = 3) -> None:
        """Checkpoint member ``k`` at campaign step ``step`` into
        ``directory`` (a tenant-namespace path): its mesh-independent
        global interiors (and extras), a sha256 per array, through the
        retrying ``utils/checkpoint.save_arrays``."""
        arrays: Dict[str, np.ndarray] = dict(self.member_interiors(k))
        for name, v in self._member_extra_arrays(k).items():
            arrays[f"extra:{name}"] = v
        meta = {"size": list(self.dd.size),
                "quantities": self.names,
                "dtypes": {q: str(self._dtype).replace("torch.", "")
                           for q in self.names},
                "member_params": self.member_params(k)}
        for key, v in (meta_extra or {}).items():
            meta[key] = v
        save_arrays(directory, step, arrays, meta=meta,
                    max_to_keep=max_to_keep)

    def restore_member(self, directory: str, k: int,
                       step: Optional[int] = None) -> int:
        """Restore member ``k`` from the newest restorable checkpoint in
        ``directory`` (or ``step``), verifying the digests and walking
        back past corrupt steps. Returns the restored step."""
        got, arrays, meta = restore_arrays(directory, step)
        if meta.get("size") and list(self.dd.size) != meta["size"]:
            raise CorruptCheckpointError(
                f"member checkpoint {directory} step {got} is of grid "
                f"{meta['size']}, not {list(self.dd.size)}")
        for q in self.names:
            self.set_member_interior(q, k, arrays[q])
        self._restore_member_extras(
            k, {key[len("extra:"):]: v for key, v in arrays.items()
                if key.startswith("extra:")})
        if meta.get("member_params"):
            self.set_member_params(k, meta["member_params"])
        return got


class EnsembleSnapshot:
    """A streaming snapshot in flight: host copies queued by
    :meth:`_EnsembleBase.member_snapshot_async`."""

    def __init__(self, engine, member: int, step: int, lanes) -> None:
        self.engine = engine
        self.member = member
        self.step = step
        self._lanes = lanes

    def ready(self) -> bool:
        return all(p.event is None or p.event.query()
                   for v in self._lanes.values() for p in v)

    def get(self) -> Dict[str, np.ndarray]:
        """Host interiors (blocks only if :meth:`ready` is False)."""
        for v in self._lanes.values():
            for p in v:
                if p.event is not None:
                    p.event.synchronize()
        return {q: self.engine.dd.gather_blocks([p.host for p in v])
                for q, v in self._lanes.items()}


# ---------------------------------------------------------------------------


class EnsembleJacobi(_EnsembleBase):
    """N independent Jacobi-3D heat runs per dispatch, with per-member
    hot/cold Dirichlet sphere temperatures (the "boundary values" of a
    parameter scan). Each step is the ``xla`` path of ``Jacobi3D``
    (exchange, the plain 7-point average, the spheres, the write-back)
    over the whole batch."""

    MODEL = "jacobi"
    PARAM_NAMES = ("hot_temp", "cold_temp")

    def default_params(self) -> Dict[str, float]:
        from ..ops.cuda_stencil import COLD_TEMP, HOT_TEMP
        return {"hot_temp": HOT_TEMP, "cold_temp": COLD_TEMP}

    def init(self) -> None:
        """Every member starts at its own mean temperature
        ``(hot + cold) / 2`` (the reference's init, per member), halos
        included."""
        means = _host_values(((self._params["hot_temp"]
                               + self._params["cold_temp"]) / 2.0)
                             .reshape(-1, 1, 1, 1), self._dtype)
        for t in self.state["temp"]:
            t.copy_(_upload(means, t.device).expand_as(t))

    def init_member(self, k: int, seed: int = 0) -> None:
        """Initial conditions for lane ``k`` alone: the member's mean
        temperature, plus a small seeded perturbation when ``seed`` is
        nonzero (distinct initial conditions per campaign)."""
        mean = (self._params["hot_temp"][k]
                + self._params["cold_temp"][k]) / 2.0
        interior = np.full(zyx_shape(self.dd.size), mean)
        if int(seed):
            rng = np.random.default_rng(int(seed))
            interior = interior + 0.01 * rng.standard_normal(
                interior.shape)
        self.set_member_interior("temp", k, interior)

    def _params_changed(self) -> None:
        # per mesh position, the (hot, cold) sphere temperatures as
        # (n_members, 1, 1, 1) tensors there
        self._temps = [(dev["hot_temp"], dev["cold_temp"])
                       for dev in self._param_dev]

    def _advance(self, n: int) -> None:
        from ..models.jacobi import jacobi_shard_step

        dd = self.dd
        for _ in range(int(n)):
            jacobi_shard_step(self.state["temp"], dd.radius, dd.mesh_counts,
                              dd.local_size, dd.size, rem=dd.rem,
                              nonperiodic=self._nonper, method=self._method,
                              temps=self._temps)


class EnsembleAstaroth(_EnsembleBase):
    """N independent MHD runs per dispatch, with per-member physics
    coefficients (viscosity / resistivity / bulk viscosity / sound
    speed — the PIConGPU-style parameter scan). Each substep is the
    ``xla`` path of ``Astaroth`` over the whole batch; bfloat16 storage
    computes in float32."""

    MODEL = "astaroth"
    PARAM_NAMES = ("nu_visc", "eta", "zeta", "cs_sound")
    PARAM_DTYPE = torch.float64

    def __init__(self, *args, params=None, **kw) -> None:
        from ..models.astaroth import MhdParams
        self.prm = params or MhdParams()
        super().__init__(*args, **kw)

    def default_params(self) -> Dict[str, float]:
        return {p: float(getattr(self.prm, p)) for p in self.PARAM_NAMES}

    def init(self, seeds: Optional[Sequence[int]] = None) -> None:
        """Per-member initial conditions: member ``k`` draws its noise
        fields from ``seeds[k]`` (default ``k``) — distinct
        trajectories even under identical physics."""
        seeds = (list(seeds) if seeds is not None
                 else list(range(self.n_members)))
        if len(seeds) != self.n_members:
            raise ValueError(f"{len(seeds)} seeds for "
                             f"{self.n_members} members")
        for k, seed in enumerate(seeds):
            self.init_member(k, seed)
        for q in self.names:
            for t in self.w[q]:
                t.zero_()

    def init_member(self, k: int, seed: int = 0) -> None:
        """Initial conditions for lane ``k`` alone: seeded noise in the
        potential/entropy fields, constant lnrho, and the radial
        explosion shell velocity (the reference's init with a per-
        member random draw). Zeroes k's RK accumulator lane."""
        from ..models.astaroth import _radial_explosion
        size = self.dd.size
        shape = zyx_shape(size)
        rng = np.random.default_rng(int(seed))
        for q in ("ax", "ay", "az", "ss"):
            self.set_member_interior(q, k,
                                     rng.uniform(-1.0, 1.0, size=shape))
        self.set_member_interior("lnrho", k, np.full(shape, 0.5))
        ux, uy, uz = _radial_explosion(size, self.prm)
        self.set_member_interior("uux", k, ux)
        self.set_member_interior("uuy", k, uy)
        self.set_member_interior("uuz", k, uz)
        for q in self.names:
            for t in self.w[q]:
                t[k].zero_()

    def _build_step(self) -> None:
        #: RK accumulators, interior-shaped (capacity) and batched, as
        #: the standalone model's xla path keeps them
        self.w: Dict[str, List[torch.Tensor]] = {
            q: self._zeros_batched(zyx_shape(self.dd.local_size))
            for q in self.names}

    def _params_changed(self) -> None:
        # per mesh position, the MhdParams whose per-member coefficients
        # are the (n_members, 1, 1, 1) float64 tensors there
        self._mprm = [dataclasses.replace(self.prm, **dev)
                      for dev in self._param_dev]

    def _w_block(self, i: int) -> Tuple[slice, slice, slice]:
        return tuple(slice(0, n) for n in zyx_shape(self.dd.shard_size(i)))

    def _advance(self, n: int) -> None:
        from ..models.astaroth import mhd_substep_shard

        dd = self.dd
        for _ in range(int(n)):
            for s in range(3):
                dispatch_exchange(self.state, dd.radius, dd.mesh_counts,
                                  self._method, rem=dd.rem,
                                  nonperiodic=self._nonper)
                for i, prm in enumerate(self._mprm):
                    w = {q: self.w[q][i] for q in self.names}
                    mhd_substep_shard({q: self.state[q][i]
                                       for q in self.names}, w, s, prm,
                                      self._dtype, dd.radius, dd.local_size,
                                      dd.alloc_radius)
                    for q in self.names:
                        self.w[q][i] = w[q]

    def state_tensors(self) -> List[torch.Tensor]:
        return super().state_tensors() + [t for v in self.w.values()
                                          for t in v]

    # RK accumulators are campaign state: a lane rollback without its
    # w would resume mid-RK-iteration with a zeroed accumulator
    def _member_extra_arrays(self, k: int) -> Dict[str, np.ndarray]:
        return {f"w:{q}": self._gather_lane(self.w[q], k, self._w_block)
                for q in self.names}

    def _restore_member_extras(self, k: int,
                               extras: Dict[str, np.ndarray]) -> None:
        for q in self.names:
            if f"w:{q}" in extras:
                self._set_lanes(self.w[q], k, extras[f"w:{q}"],
                                self._w_block)

    def reset_member(self, k: int) -> None:
        super().reset_member(k)
        for q in self.names:
            for t in self.w[q]:
                t[k].zero_()
