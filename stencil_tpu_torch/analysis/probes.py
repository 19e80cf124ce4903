"""What the port's checkers watch a run through, in place of JAX's jaxprs.

JAX's checkers read the traced program (jaxprs, lowered StableHLO). The
port runs eager PyTorch and hand-written kernels, so its checkers run
the code they check, at small sizes on the CPU (over the plain twins) or
on the card, and watch it:

* :class:`OpLog` — a ``TorchDispatchMode`` that sees every aten op: its
  name, dtypes, the tensors it allocates (an output whose storage no
  input holds), host syncs (``aten._local_scalar_dense``: ``.item()``,
  ``bool(t)``) and ops with data-dependent shapes, and JAX's
  ``jaxpr_flops`` weights applied to the elementwise ops it sees;
* :class:`DistShim` — a recording stand-in for ``torch.distributed``
  that lets one process run the view of one rank of a world: every
  point-to-point message and every collective the code calls is logged
  with its bytes, peer and tag, and nothing is sent;
* the exchange engines' message probe (``parallel/exchange.WireProbe``,
  installed for a block by ``parallel/exchange.recording``), which logs
  every message between two mesh positions of one process.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: JAX's ``jaxpr_flops`` weights (stencil_tpu/analysis/costmodel.py:39-47),
#: by the aten ops that compute those primitives
_FLOP_1 = frozenset({
    "add", "sub", "rsub", "mul", "maximum", "minimum", "neg", "abs", "sign",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_not", "where", "clamp",
    "clamp_min", "clamp_max", "square"})
_FLOP_5 = frozenset({"div", "remainder", "fmod", "sqrt", "rsqrt", "pow",
                     "reciprocal"})
_FLOP_10 = frozenset({"exp", "expm1", "log", "log1p", "sin", "cos", "tan",
                      "tanh", "sigmoid", "atan2", "erf", "erfinv", "erfc"})
#: aten ops whose output shape depends on the data: on a card each one
#: waits for the device to learn the shape (a host sync)
DATA_DEPENDENT = frozenset({"nonzero", "masked_select", "unique",
                            "_unique2", "unique_consecutive",
                            "nonzero_static"})
#: additive reductions (precision condition (a): the accumulation floor)
REDUCTIONS = frozenset({"sum", "mean", "nansum", "cumsum", "index_add",
                        "scatter_add", "mm", "bmm", "addmm", "matmul",
                        "dot"})


@dataclasses.dataclass
class OpRecord:
    name: str
    out_dtypes: List[torch.dtype]
    in_dtypes: List[torch.dtype]
    out_numel: int


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _storage_key(t: torch.Tensor):
    if t.device.type == "meta":
        return None
    try:
        return (t.device, t.untyped_storage().data_ptr())
    except (RuntimeError, NotImplementedError):
        return None


class OpLog(TorchDispatchMode):
    """Every aten op a block runs (``with OpLog() as log:``): ``ops``
    (``OpRecord`` each), ``allocations`` (bytes of each new storage an
    op's output took), ``syncs`` (the names of host-syncing ops),
    ``flops`` (JAX's weights)."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[OpRecord] = []
        self.allocations: List[int] = []
        self.syncs: List[str] = []
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.rstrip("_") \
            if not func.overloadpacket.__name__.startswith("_") \
            else func.overloadpacket.__name__
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        numel = sum(t.numel() for t in outs)
        self.ops.append(OpRecord(name, [t.dtype for t in outs],
                                 [t.dtype for t in ins], numel))
        held = {_storage_key(t) for t in ins}
        for t in outs:
            key = _storage_key(t)
            if key is not None and key not in held:
                held.add(key)
                self.allocations.append(t.untyped_storage().nbytes())
        if name == "_local_scalar_dense" or name in DATA_DEPENDENT:
            self.syncs.append(name)
        base = name.rstrip("_")
        if base in _FLOP_1:
            self.flops += numel
        elif base in _FLOP_5:
            self.flops += 5 * numel
        elif base in _FLOP_10:
            self.flops += 10 * numel
        return out

    def names(self) -> List[str]:
        return [r.name for r in self.ops]


# ---------------------------------------------------------------------------
# torch.distributed, recorded
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DistCall:
    """One call a rank made: ``name`` ("isend", "irecv" or a collective's
    name), the ``peer`` and ``tag`` of a point-to-point message (-1
    otherwise), and the tensor bytes it carries."""
    rank: int
    name: str
    peer: int
    tag: int
    nbytes: int


#: the collectives ``DistShim`` stands in for (every one the port could
#: call); each is recorded and does nothing
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "broadcast", "broadcast_object_list",
               "all_to_all", "all_to_all_single", "reduce",
               "reduce_scatter", "reduce_scatter_tensor", "gather",
               "scatter", "barrier", "send", "recv")
POINT_TO_POINT = ("isend", "irecv")


class _P2POp:
    def __init__(self, op, tensor, peer=None, group=None, tag=0,
                 group_peer=None) -> None:
        self.op, self.tensor, self.peer, self.tag = op, tensor, peer, tag


class DistShim:
    """``with DistShim(rank, world):`` — ``torch.distributed`` as rank
    ``rank`` of a ``world``-rank gloo group sees it, with nothing sent:
    ``batch_isend_irecv`` logs each message (its receive buffers keep
    what they held), every collective of ``COLLECTIVES`` logs and
    returns (``all_gather`` and ``all_gather_object`` fill the output
    with this rank's input). ``calls`` holds the log."""

    def __init__(self, rank: int, world: int, backend: str = "gloo") -> None:
        self.rank, self.world, self.backend = rank, world, backend
        self.calls: List[DistCall] = []
        self._saved: Dict[str, Any] = {}

    def _log(self, name: str, tensors=(), peer: int = -1,
             tag: int = -1) -> None:
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(tensors))
        self.calls.append(DistCall(self.rank, name, int(peer), int(tag),
                                   nbytes))

    def _patch(self) -> Dict[str, Any]:
        me = self

        def batch(ops):
            for op in ops:
                kind = "isend" if op.op is me._isend else "irecv"
                me._log(kind, op.tensor, op.peer, op.tag)
            return []

        def isend(tensor, dst=None, group=None, tag=0, **kw):
            me._log("isend", tensor, dst, tag)

        def irecv(tensor, src=None, group=None, tag=0, **kw):
            me._log("irecv", tensor, src, tag)

        me._isend, me._irecv = isend, irecv

        def collective(name):
            def call(*args, **kw):
                me._log(name, args[:2])
                if name == "all_gather" and args:
                    for t in args[0]:
                        t.copy_(args[1])
                if name == "all_gather_object" and args:
                    for k in range(len(args[0])):
                        args[0][k] = args[1]
            return call

        patch = {
            "is_available": lambda: True,
            "is_initialized": lambda: True,
            "get_rank": lambda *a, **k: me.rank,
            "get_world_size": lambda *a, **k: me.world,
            "get_backend": lambda *a, **k: me.backend,
            "P2POp": _P2POp, "isend": isend, "irecv": irecv,
            "batch_isend_irecv": batch,
        }
        for name in COLLECTIVES:
            patch[name] = collective(name)
        return patch

    def __enter__(self) -> "DistShim":
        import torch.distributed as dist

        for name, value in self._patch().items():
            self._saved[name] = getattr(dist, name, None)
            setattr(dist, name, value)
        return self

    def __exit__(self, *exc) -> None:
        import torch.distributed as dist

        for name, value in self._saved.items():
            if value is None:
                delattr(dist, name)
            else:
                setattr(dist, name, value)
        self._saved.clear()


def rank_views(run: Callable[[int], Any], ranks: Sequence[int]
               ) -> List[DistCall]:
    """Run ``run(r)`` as each rank ``r`` of ``ranks`` (the owners of the
    mesh positions) sees the world, under ``DistShim``; returns every
    rank's calls."""
    world = max(ranks) + 1
    calls: List[DistCall] = []
    for r in sorted(set(ranks)):
        with DistShim(r, world) as shim:
            run(r)
        calls.extend(shim.calls)
    return calls


def unmatched_messages(calls: Sequence[DistCall]) -> List[str]:
    """Every point-to-point message that meets no receive (a send from
    r to p with tag t and b bytes needs a receive at p from r with that
    tag and those bytes), and every receive that meets no send."""
    from collections import Counter

    sends = Counter((c.rank, c.peer, c.tag, c.nbytes) for c in calls
                    if c.name == "isend")
    recvs = Counter((c.peer, c.rank, c.tag, c.nbytes) for c in calls
                    if c.name == "irecv")
    out = []
    for key, n in (sends - recvs).items():
        out.append(f"{n} send(s) {key[0]} -> {key[1]} (tag {key[2]}, "
                   f"{key[3]} B) meet no receive")
    for key, n in (recvs - sends).items():
        out.append(f"{n} receive(s) at {key[1]} from {key[0]} (tag "
                   f"{key[2]}, {key[3]} B) meet no send")
    return out

