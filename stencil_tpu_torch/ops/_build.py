"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain ``extern "C"`` interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC

(plus ``-Xptxas=-v``, which prints each kernel's registers and shared
memory with the build log and changes no code). ``-fmad=false`` keeps
every multiply and add separately rounded, as the plain PyTorch twins
round them. Libraries land in
``stencil_tpu_torch/_build/`` (ignored by git), named by a hash of the
source and the flags, and are built at first use. ``nvcc`` is looked up
only when a build is needed, so the package imports on a machine with
no CUDA toolkit; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: libraries nvcc built in this process (``analysis/recompile.py``)
BUILDS = 0


def sources() -> Dict[str, Path]:
    """Every kernel source of the package, by library name."""
    return {p.stem: p for p in sorted(SRC_DIR.glob("*.cu"))}


def find_nvcc() -> str:
    """``$NVCC``, else ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``
    (default ``/usr/local/cuda``)."""
    cand = os.environ.get("NVCC") or shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME): the CUDA "
                       "kernels of stencil_tpu_torch cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes with
    ``#include "..."``, directly or through another header, in the order
    first met."""
    seen: List[Path] = []
    todo = [sources()[name]]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        todo += [SRC_DIR / m.decode() for m in _INCLUDE.findall(p.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: keyed by a
    hash of the source text, of every header it includes and of the
    flags, so that a changed header never loads a stale library."""
    h = hashlib.sha256()
    for p in source_files(name):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build the named libraries (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    seconds each build took (0.0 when it was already built). Raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(srcs[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{srcs[name].name}:\n{log}")
            continue
        if log.strip():
            print(f"nvcc {srcs[name].name}:\n{log}", flush=True)
        os.replace(tmp, out)
    global BUILDS
    BUILDS += len(procs) - len(failed)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def ptxas_usage(log: str, lib: Optional[str] = None
                ) -> Dict[tuple, Dict[str, int]]:
    """Registers, spill bytes and static shared memory of every kernel
    in the ``-Xptxas=-v`` lines of a build log: (library, mangled name)
    -> {"registers", "spill_stores", "spill_loads", "static_smem"}. The
    library is the one named by the last ``nvcc <name>.cu:`` line (as
    ``build_all`` heads each library's output), else ``lib``."""
    out: Dict[tuple, Dict[str, int]] = {}
    key = None
    for line in log.splitlines():
        m = re.match(r"nvcc (\w+)\.cu:", line)
        if m:
            lib, key = m.group(1), None
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            key = (lib, m.group(1))
            continue
        if key is None:
            continue
        use = out.setdefault(key, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            use.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            use["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            use["static_smem"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, building it
    first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def launch(name: str, fn_name: str, argtypes, device, *args) -> None:
    """Call the launcher ``fn_name`` of library ``name`` with ``args`` on
    ``device``, the CUDA device that holds the launch's tensors: with it
    as the current device and its current PyTorch stream as the last
    argument, so that the kernel is ordered after the work PyTorch
    queued on that device (and a copy from another device waits for it).
    Raise if the launcher returns a CUDA error (a refused launch never
    runs, and no later synchronize would report it)."""
    import torch

    fn = getattr(load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int   # cudaError_t
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
