"""Print the machine and mesh model: the process, its devices, memory.

PyTorch-port counterpart of ``apps/machine_info.py`` (reference:
bin/machine_info.cu, the Machine model of include/stencil/machine.hpp):
one process holds every shard (ROADMAP A4b brings one process per card),
so it prints that process, the devices the device flags name (every
visible CUDA device by default), each with its name, memory and SM
count, and the default 3D mesh over them. Run it as

    python -m stencil_tpu_torch.apps.machine_info
    python -m stencil_tpu_torch.apps.machine_info --devices cpu,cpu
"""

from __future__ import annotations

import argparse

from ._common import add_device_flags, devices_from_args


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flags(ap, mesh=False)
    args = ap.parse_args(argv)

    import torch

    from ..parallel.mesh import default_mesh_shape, make_mesh

    devs = [torch.device(d) for d in devices_from_args(args)]
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print("process 0 of 1")
    print(f"devices: {len(devs)} (visible CUDA devices: {visible})")
    for i, d in enumerate(devs):
        if d.type == "cuda":
            p = torch.cuda.get_device_properties(d)
            print(f"  [{i}] {p.name} platform=cuda device={d} "
                  f"sm={p.major}{p.minor} sms={p.multi_processor_count} "
                  f"mem={p.total_memory / 2**30:.1f}GiB")
        else:
            print(f"  [{i}] host platform={d.type} device={d}")
    shape = default_mesh_shape(len(devs))
    mesh = make_mesh(shape, devs)
    print(f"default 3D mesh: {tuple(mesh.shape)} axes ('x', 'y', 'z')")


if __name__ == "__main__":
    main()
