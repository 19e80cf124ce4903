"""stencil_tpu_torch: the PyTorch/CUDA port of stencil_tpu.

The JAX package ``stencil_tpu`` is the reference; this package mirrors
its layout and names module by module (``geometry``, ``partition``,
``distributed``, ``parallel.exchange``, ``ops.stencil_kernels``,
``ops.fd6``, ``models.jacobi``, ``models.astaroth``...), with plain
functions on tensors and an explicit ``device``. The Pallas TPU kernels
become hand-written CUDA kernels for Hopper in ``csrc/``, bound through
``ops/_build.py`` and wrapped in ``ops/cuda_stencil.py`` and
``ops/cuda_mhd.py`` beside plain PyTorch twins.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
This package imports nothing of JAX or of ``stencil_tpu``.
"""

from .distributed import DistributedDomain
from .geometry import Dim3, Radius, Rect3, all_directions
from .models.astaroth import Astaroth, MhdParams
from .models.jacobi import Jacobi3D
from .parallel.methods import Method
from .topology import Boundary, Topology

__all__ = ["Astaroth", "Boundary", "Dim3", "DistributedDomain", "Jacobi3D",
           "Method", "MhdParams", "Radius", "Rect3", "Topology",
           "all_directions"]
