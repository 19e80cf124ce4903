"""Print the machine and mesh model: the processes, their devices,
memory.

PyTorch-port counterpart of ``apps/machine_info.py`` (reference:
bin/machine_info.cu, the Machine model of include/stencil/machine.hpp):
this process's rank, the world size, its host and the process group's
backend, then the mesh's devices — every rank's under torchrun, else
the ones the device flags name (every visible CUDA device by default) —
each with its owner rank, name, memory and SM count, and the default 3D
mesh over them. Run it as

    python -m stencil_tpu_torch.apps.machine_info
    python -m stencil_tpu_torch.apps.machine_info --devices cpu,cpu
    python -m torch.distributed.run --nproc_per_node 2 \\
        -m stencil_tpu_torch.apps.machine_info --backend gloo
"""

from __future__ import annotations

import argparse
import socket

from ..parallel.multihost import initialize_distributed
from ._common import add_device_flags, devices_from_args


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flags(ap, mesh=False)
    args = ap.parse_args(argv)
    initialize_distributed(backend=args.backend)

    import torch

    from ..parallel.mesh import as_global, default_mesh_shape, make_mesh
    from ..parallel.multihost import backend, process_count, process_index

    devs = [as_global(d) for d in devices_from_args(args)]
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"process {process_index()} of {process_count()} on "
          f"{socket.gethostname()}, backend {backend() or 'none'}")
    print(f"devices: {len(devs)} (visible CUDA devices here: {visible})")
    for i, g in enumerate(devs):
        d = g.device
        mine = g.rank == process_index()
        if d.type == "cuda" and mine:
            p = torch.cuda.get_device_properties(d)
            print(f"  [{i}] rank {g.rank} {p.name} platform=cuda device={d} "
                  f"sm={p.major}{p.minor} sms={p.multi_processor_count} "
                  f"mem={p.total_memory / 2**30:.1f}GiB")
        else:
            print(f"  [{i}] rank {g.rank} host={g.host} platform={d.type} "
                  f"device={d}")
    shape = default_mesh_shape(len(devs))
    mesh = make_mesh(shape, devs)
    print(f"default 3D mesh: {tuple(mesh.shape)} axes ('x', 'y', 'z')")


if __name__ == "__main__":
    main()
