"""chip_smoke.py's analysis phase alone on one card (after building
every kernel), then B8 bfloat16's timing of its phase 5.

    python3 probe/analysis_probe.py
"""
import contextlib, io, sys, time, subprocess
sys.path.insert(0, ".")
import torch
import chip_smoke as smoke
from stencil_tpu_torch.ops import _build, cuda_stencil as cs
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout, flush=True)
buf = io.StringIO()
t0 = time.time()
with contextlib.redirect_stdout(buf):
    _build.build_all()
print("build s", round(time.time() - t0, 1), flush=True)
t0 = time.time()
res = smoke.run_analysis(torch)
print("analysis s", round(time.time() - t0, 1), res["b8_bf16_launches"], flush=True)
for k, v in res["occupancy"].items():
    print("occ", k, v)
for k, v in res["builds"].items():
    print("build", k, v)
print("warnings", res["warnings"])
t0 = time.time()
print(smoke.time_laplace6_bf16(torch, cs))
print("time s", round(time.time() - t0, 1), flush=True)
