"""Placement: subdomain index <-> device, trivial subset.

PyTorch-port counterpart of ``stencil_tpu/placement.py`` (reference:
partition.hpp:264-445). The JAX package's default (``mode="auto"``)
keeps the trivial order on a uniform fabric and refines it with a QAP
solve only on a non-uniform one. An NVSwitch H100 node is uniform (every
pair of cards one NVLink hop apart), and so is a device list that
repeats one card, so the port ships the trivial branch: subdomain ``i``
(x fastest) runs on ``devices[i]``. ``mode="qap"`` raises until
``qap.py`` is ported (ROADMAP A5). A device may be a
``parallel/mesh.GlobalDevice`` (a mesh over processes); the placement
keeps its owner rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .geometry import Dim3, Dim3Like
from .parallel.mesh import GlobalDevice, as_global
from .partition import RankPartition

PLACEMENT_MODES = ("auto", "qap", "trivial")


class Placement:
    """Bijection subdomain index <-> device slot (reference:
    partition.hpp:264-289): subdomain with linear id ``i`` (x fastest,
    ``part.linearize``) runs on ``devices[assignment[i]]``."""

    def __init__(self, part: RankPartition, devices: Sequence,
                 assignment: Optional[List[int]] = None) -> None:
        self.part = part
        self.slots: List[GlobalDevice] = [as_global(d) for d in devices]
        self.devices = [g.device for g in self.slots]
        n = part.dim().flatten()
        if len(self.devices) != n:
            raise ValueError(f"{len(self.devices)} devices for {n} "
                             f"subdomains")
        self.assignment = assignment or list(range(n))

    def dim(self) -> Dim3:
        return self.part.dim()

    def subdomain_size(self, idx: Dim3Like) -> Dim3:
        return self.part.subdomain_size(Dim3.of(idx))

    def subdomain_origin(self, idx: Dim3Like) -> Dim3:
        return self.part.subdomain_origin(Dim3.of(idx))

    def slot_order_for_mesh(self) -> List[GlobalDevice]:
        """Devices with their owner ranks, ordered by subdomain linear
        index (x fastest), for ``parallel.mesh.Mesh``."""
        return [self.slots[self.assignment[i]]
                for i in range(len(self.slots))]


def normalize_placement_mode(mode: Optional[str]) -> str:
    m = "auto" if mode is None else str(mode)
    if m not in PLACEMENT_MODES:
        raise ValueError(f"unknown placement mode {mode!r} "
                         f"(expected one of {PLACEMENT_MODES})")
    return m


def make_placement(part: RankPartition, devices: Sequence,
                   mode: str = "auto") -> Placement:
    """The trivial placement (``auto`` on a uniform fabric, or
    ``trivial``); ``qap`` raises ``NotImplementedError``."""
    if normalize_placement_mode(mode) == "qap":
        raise NotImplementedError(
            "placement mode 'qap' needs the QAP solver (stencil_tpu/qap.py), "
            "not ported yet: ROADMAP A5")
    return Placement(part, list(devices))
