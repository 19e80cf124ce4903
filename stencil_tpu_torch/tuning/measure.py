"""Measurement harness: short timing loops over the live mesh.

PyTorch-port counterpart of ``stencil_tpu/tuning/measure.py``. Two
timers share one interface:

* :class:`MeshTimer` — the real thing: ``pingpong(nbytes)`` times one
  ring shift of an ``nbytes`` message along a mesh axis through the
  port's transport (a device-to-device copy between shards of this
  process, a ``RankMessages`` message between ranks) and
  ``exchange_round(candidate, geom)`` times one exchange round of the
  candidate's configuration on zero fields of the deployed layout and
  dtypes, built by the same ``make_exchange`` (``parallel/exchange.py``)
  ``DistributedDomain.realize`` deploys — B4 for ``PallasDMA`` on the
  card — or, for per-axis depths, one group through
  ``parallel/temporal.temporal_shard_steps``. Each time is the median
  of ``WINDOWS`` windows, each a host clock around ``reps`` calls fenced
  by a ``torch.cuda.synchronize`` of every card of the mesh, after one
  untimed call (which builds the kernels and B4's launch table); the
  windows' per-call times stay in ``last_windows``, and the plan keeps
  their spread beside each measured candidate.
* :class:`FakeTimer` — deterministic: evaluates the analytic model
  (``analysis/costmodel.exchange_round_model``) from injected
  coefficients, so that search, fit, pruning and cache are exercised
  exactly on the CPU.

:class:`CountingTimer` wraps either and counts invocations: the plan's
``measurements``, zero on a cache hit.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..analysis.costmodel import LinkCoefficients, exchange_round_model
from ..geometry import Dim3
from .plan import Candidate, TuneGeometry

#: timing windows a measurement takes the median of: a host stall moves
#: one window's time, not the median
WINDOWS = 5


class FakeTimer:
    """Deterministic measurement stand-in driven by injected alpha-beta
    coefficients, with optional per-method scale factors for tests that
    need a given winner (JAX ``tuning/measure.py:37-102``)."""

    def __init__(self, coeffs: Optional[LinkCoefficients] = None,
                 scale: Optional[Dict[str, float]] = None,
                 dcn_coeffs: Optional[LinkCoefficients] = None,
                 axis_coeffs: Optional[
                     Dict[str, LinkCoefficients]] = None) -> None:
        self.coeffs = coeffs if coeffs is not None else LinkCoefficients(
            alpha_s=50e-6, beta_bytes_per_s=1e10)
        self.scale = dict(scale or {})
        self.dcn_coeffs = dcn_coeffs
        #: per-mesh-axis coefficients for ``pingpong_axis`` (the
        #: topology fingerprint); other axes take ``coeffs``
        self.axis_coeffs = dict(axis_coeffs or {})

    @property
    def has_dcn(self) -> bool:
        return self.dcn_coeffs is not None

    def pingpong(self, nbytes: int) -> float:
        return self.coeffs.seconds(1, nbytes)

    def pingpong_dcn(self, nbytes: int) -> float:
        assert self.dcn_coeffs is not None, "no DCN link configured"
        return self.dcn_coeffs.seconds(1, nbytes)

    def pingpong_axis(self, name: str, nbytes: int) -> float:
        return self.axis_coeffs.get(name, self.coeffs).seconds(1, nbytes)

    def exchange_round(self, cand: Candidate, geom: TuneGeometry
                       ) -> float:
        depths = cand.depths_xyz()
        if len(set(depths)) > 1:
            # an asymmetric group: axis a re-ships its deep slab s / s_a
            # times (parallel/temporal.refresh_axes)
            from ..analysis.costmodel import per_axis_round_model
            per_axis = per_axis_round_model(
                cand.method, geom.shard_interior_zyx, geom.radius,
                geom.counts, geom.elem_sizes, depths,
                geom.dtype_groups, wire_format=cand.wire_format,
                wire_layout=cand.wire_layout)
            s = max(depths)
            messages = sum(per_axis[n][0] * (s // depths[a])
                           for a, n in enumerate("xyz"))
            nbytes = sum(per_axis[n][1] * (s // depths[a])
                         for a, n in enumerate("xyz"))
        else:
            messages, nbytes = exchange_round_model(
                cand.method, geom.shard_interior_zyx, geom.radius,
                geom.counts, geom.elem_sizes, cand.exchange_every,
                geom.dtype_groups, wire_format=cand.wire_format,
                wire_layout=cand.wire_layout)
        t = self.coeffs.seconds(messages, nbytes)
        return t * self.scale.get(cand.method, 1.0)


class MeshTimer:
    """Timing loops on the live mesh (``parallel/mesh.Mesh``): one
    timing field per dtype of ``dtypes`` (torch dtypes), ``local`` the
    shard capacity, ``rem``/``nonperiodic`` as the domain's, so that the
    timed exchange is the one ``realize()`` builds. A mesh over
    processes is timed by every rank together (the exchange's messages
    are collective)."""

    def __init__(self, mesh, local: Dim3, dtypes: Sequence,
                 rem: Dim3 = Dim3(0, 0, 0), nonperiodic: bool = False,
                 reps: int = 5, dcn_axis: Optional[int] = None) -> None:
        self.mesh = mesh
        self.local = Dim3.of(local)
        self.dtypes = list(dtypes)
        self.rem = rem
        self.nonperiodic = nonperiodic
        self.reps = max(int(reps), 1)
        self.dcn_axis = dcn_axis
        #: the last timing's per-call seconds, one a window
        self.last_windows: List[float] = []

    @property
    def has_dcn(self) -> bool:
        return self.dcn_axis is not None

    def _own(self):
        return [(i, self.mesh.devices[i]) for i in self.mesh.local_positions]

    def _sync(self) -> None:
        for d in {d for _, d in self._own()}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _timed(self, fn) -> float:
        """Seconds a call of ``fn`` after one untimed call: the median
        over ``WINDOWS`` windows of ``reps`` calls, each between two
        synchronizes of every card of the mesh (a host stall moves one
        window, not the median)."""
        fn()
        self._sync()
        per_call = []
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            for _ in range(self.reps):
                fn()
            self._sync()
            per_call.append((time.perf_counter() - t0) / self.reps)
        self.last_windows = per_call
        return statistics.median(per_call)

    def pingpong(self, nbytes: int) -> float:
        """Seconds a ring shift of one ``nbytes`` message along the
        largest mesh axis (the alpha-beta sample source)."""
        counts = self.mesh.shape
        name = max("zyx", key=lambda k: counts["xyz".index(k)])
        return self._ring_shift_seconds(name, nbytes)

    def pingpong_dcn(self, nbytes: int) -> float:
        """The same along the host-blocked (DCN) axis."""
        assert self.dcn_axis is not None, "no DCN axis configured"
        return self._ring_shift_seconds("xyz"[self.dcn_axis], nbytes)

    def pingpong_axis(self, name: str, nbytes: int) -> float:
        """The same along one named mesh axis (the topology
        fingerprint's per-axis samples)."""
        return self._ring_shift_seconds(name, nbytes)

    def _ring_shift_seconds(self, name: str, nbytes: int) -> float:
        from ..parallel.mesh import mesh_neighbor
        from ..parallel.multihost import RankMessages

        axis = "xyz".index(name)
        counts = self.mesh.shape
        n = counts[axis]
        elems = max(int(nbytes) // 4, 1)
        own = self._own()
        src = {i: torch.zeros(elems, dtype=torch.float32, device=d)
               for i, d in own}
        dst = {i: torch.empty_like(t) for i, t in src.items()}
        ranks = self.mesh.ranks
        me = self.mesh.rank

        def shift():
            if n == 1:
                for t in src.values():
                    t.add_(1.0)
                return
            msgs = None
            # messages in one global order, by destination position
            # (what NCCL's pairwise matching needs)
            for j, i in sorted((mesh_neighbor(i, counts, axis, 1), i)
                               for i, _ in own):
                if ranks[j] == me:
                    dst[j].copy_(src[i])
                    continue
                if msgs is None:
                    msgs = RankMessages()
                msgs.send(src[i], ranks[j], tag=j)
            for j, d in own:
                i = mesh_neighbor(j, counts, axis, -1)
                if ranks[i] != me:
                    if msgs is None:
                        msgs = RankMessages()
                    msgs.recv((elems,), torch.float32, d, ranks[i], tag=j,
                              land=lambda buf, j=j: dst[j].copy_(buf))
            if msgs is not None:
                msgs.run()

        return self._timed(shift)

    def _zero_fields(self, radius):
        from ..local_domain import raw_size, zyx_shape

        shape = zyx_shape(raw_size(self.local, radius))
        own = dict(self._own())
        n = len(self.mesh.devices)
        fields = {f"q{k}": [torch.zeros(shape, dtype=dt, device=own[i])
                            if i in own else None for i in range(n)]
                  for k, dt in enumerate(self.dtypes)}
        spec = {q: (shape, dt) for q, dt in
                zip(fields, self.dtypes)}
        return fields, spec

    def exchange_round(self, cand: Candidate, geom: TuneGeometry
                       ) -> float:
        """Seconds of one exchange round of ``cand``'s configuration on
        zero fields, through the exchange ``realize()`` deploys. A
        per-axis candidate times one whole group (the deep exchange and
        every mid-group refresh, with an identity update) through
        ``temporal_shard_steps``; the caller divides by the depth
        either way."""
        from ..parallel.exchange import make_exchange
        from ..parallel.methods import Method

        if len(set(cand.depths_xyz())) > 1:
            return self._asym_group_seconds(cand, geom)
        deep = geom.radius.deepened(cand.exchange_every)
        fields, spec = self._zero_fields(deep)
        kw = {}
        if cand.wire_format != "f32":
            kw = dict(wire_format=cand.wire_format, fields_spec=spec)
        ex = make_exchange(self.mesh, deep, Method[cand.method],
                           rem=self.rem, nonperiodic=self.nonperiodic,
                           wire_layout=cand.wire_layout, **kw)
        # the port's engines work in place: the same fields every call
        return self._timed(lambda: ex(fields))

    def _asym_group_seconds(self, cand: Candidate, geom: TuneGeometry
                            ) -> float:
        from ..parallel.methods import Method
        from ..parallel.temporal import temporal_shard_steps

        depths = Dim3(*cand.depths_xyz())
        radius = geom.radius
        fields, _ = self._zero_fields(radius.deepened(depths))
        r_lo = radius.pad_lo()

        def identity(blocks, dims, off, k, i):
            return {q: b[r_lo.z:r_lo.z + dims.z, r_lo.y:r_lo.y + dims.y,
                         r_lo.x:r_lo.x + dims.x]
                    for q, b in blocks.items()}

        def group():
            temporal_shard_steps(
                fields, radius, self.mesh.shape, Method[cand.method],
                identity, depths, rem=self.rem,
                nonperiodic=self.nonperiodic,
                wire_format=(cand.wire_format
                             if cand.wire_format != "f32" else None),
                wire_layout=cand.wire_layout, ranks=self.mesh.peers)

        return self._timed(group)


class CountingTimer:
    """Delegating wrapper that counts timer invocations: the plan's
    ``measurements``."""

    def __init__(self, timer) -> None:
        self._timer = timer
        self.calls = 0

    @property
    def has_dcn(self) -> bool:
        return bool(getattr(self._timer, "has_dcn", False))

    @property
    def last_windows(self) -> List[float]:
        return list(getattr(self._timer, "last_windows", ()))

    def pingpong(self, nbytes: int) -> float:
        self.calls += 1
        return self._timer.pingpong(nbytes)

    def pingpong_dcn(self, nbytes: int) -> float:
        self.calls += 1
        return self._timer.pingpong_dcn(nbytes)

    def pingpong_axis(self, name: str, nbytes: int) -> float:
        self.calls += 1
        return self._timer.pingpong_axis(name, nbytes)

    def exchange_round(self, cand: Candidate, geom: TuneGeometry
                       ) -> float:
        self.calls += 1
        return self._timer.exchange_round(cand, geom)
