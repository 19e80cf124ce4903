"""B8's laplace6 kernel on one card: build it, read its ptxas usage and
occupancy (float32 and bfloat16), hold both instances against the twin
at B8's shapes, and time both at 256^3 by events and by device time.

    python3 probe/b8_probe.py
"""
import io, contextlib, sys, time, json, subprocess
sys.path.insert(0, ".")
import torch
import chip_smoke as smoke
from stencil_tpu_torch.ops import _build, cuda_stencil as cs
from stencil_tpu_torch.geometry import Dim3, Radius
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout)
buf = io.StringIO()
t0 = time.time()
with contextlib.redirect_stdout(buf):
    _build.build_all(["laplace6"])
print("build s", time.time() - t0)
use = _build.ptxas_usage(buf.getvalue())
for k, v in use.items():
    print(k, v)
dev = torch.device("cuda")
print("occupancy f32", cs.laplace6_occupancy(dev), "bf16", cs.laplace6_occupancy(dev, 2), "model", cs.laplace6_blocks_per_sm())
print("worst f32", smoke.compare_laplace6(torch, cs))
print("worst bf16", smoke.compare_laplace6(torch, cs, torch.bfloat16))
n = 256
inv = smoke.mhd_inv_ds()
r3 = Radius.constant(3)
for dt in (torch.float32, torch.bfloat16, torch.float32, torch.bfloat16):
    pad = torch.randn((n + 6,) * 3, device=dev).to(dt)
    out = torch.empty((n,) * 3, device=dev, dtype=dt)
    f = lambda: cs.laplace6_cuda(pad, r3, Dim3(n, n, n), inv, out=out)
    ev = smoke.event_ms(torch, f, 20) if hasattr(smoke, "event_ms") else None
    dm = smoke.device_ms(torch, f, 20, warmup=3)
    print(dt, "events ms", ev, "device ms", dm)
