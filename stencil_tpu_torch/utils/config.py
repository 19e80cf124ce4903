"""Environment switches and the ``key = value`` configuration loader.

PyTorch-port counterpart of ``stencil_tpu/utils/config.py``; the
switch names and meanings are the same in both packages, so one
environment drives both:

* ``STENCIL_DISABLE_WRAP2`` (``wrap2_disabled``) — Jacobi wrap path;
* ``STENCIL_MHD_PAIR`` (``mhd_pair_requested``) — Astaroth wrap path.

``STENCIL_MHD_THINZ`` has no counterpart here: in the JAX package it
only picks the TPU kernel's DMA window plan (thin single-row z segments
or tiled ones) and never changes a result, and the port's CUDA kernels
have no such plan.

``load_config``/``parse_config`` read an astaroth.conf-style file
(reference: astaroth/astaroth_utils.cu acLoadConfig,
astaroth/astaroth.conf): lines of ``name = value`` with ``//`` and
``/* */`` comments; int-valued and real-valued names land in separate
tables, like AcMeshInfo's int_params/real_params.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Tuple


def wrap2_disabled() -> bool:
    """STENCIL_DISABLE_WRAP2=1 is the kill-switch that sends the wrap
    path to the single-step kernel only ("0" and unset both leave the
    N-step kernel on)."""
    return (os.environ.get("STENCIL_DISABLE_WRAP2", "").lower()
            in ("1", "true", "yes"))


def mhd_pair_requested() -> bool:
    """STENCIL_MHD_PAIR=1 opts the Astaroth wrap path into the fused RK
    substep-0+1 pair kernel ("0" and unset leave it off)."""
    return (os.environ.get("STENCIL_MHD_PAIR", "").lower()
            in ("1", "true", "yes"))


def load_config(path: str) -> Tuple[Dict[str, int], Dict[str, float]]:
    """Parse a conf file into (int_params, real_params)."""
    with open(path) as f:
        text = f.read()
    return parse_config(text)


def parse_config(text: str) -> Tuple[Dict[str, int], Dict[str, float]]:
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    int_params: Dict[str, int] = {}
    real_params: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.split("//")[0].strip()
        if not line or "=" not in line:
            continue
        name, _, val = line.partition("=")
        name = name.strip()
        val = val.strip()
        if not name or not val:
            continue
        try:
            if re.fullmatch(r"[+-]?\d+", val):
                int_params[name] = int(val)
            else:
                real_params[name] = float(val)
        except ValueError:
            continue  # non-numeric values are ignored, as in the reference
    return int_params, real_params
