"""Placement: subdomain index <-> device, trivial subset.

PyTorch-port counterpart of ``stencil_tpu/placement.py`` (reference:
partition.hpp:264-445). The JAX package's default (``mode="auto"``)
keeps the trivial order on a uniform fabric and refines it with a QAP
solve only on a non-uniform one. An NVSwitch H100 node is uniform (every
pair of cards one NVLink hop apart), and so is a device list that
repeats one card, so the port ships the trivial branch: subdomain ``i``
(x fastest) runs on ``devices[i]``. ``mode="qap"`` raises until
``qap.py`` is ported (ROADMAP A5).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .geometry import Dim3, Dim3Like
from .partition import RankPartition

PLACEMENT_MODES = ("auto", "qap", "trivial")


class Placement:
    """Bijection subdomain index <-> device slot (reference:
    partition.hpp:264-289): subdomain with linear id ``i`` (x fastest,
    ``part.linearize``) runs on ``devices[assignment[i]]``."""

    def __init__(self, part: RankPartition, devices: Sequence,
                 assignment: Optional[List[int]] = None) -> None:
        self.part = part
        self.devices = [torch.device(d) for d in devices]
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

    def device_order_for_mesh(self) -> List[torch.device]:
        """Devices ordered by subdomain linear index (x fastest), for
        ``parallel.mesh.Mesh``."""
        return [self.devices[self.assignment[i]]
                for i in range(len(self.devices))]


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
