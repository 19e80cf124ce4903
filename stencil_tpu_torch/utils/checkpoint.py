"""Checkpoint / resume for distributed domain state.

PyTorch-port counterpart of ``stencil_tpu/utils/checkpoint.py``, which
writes with orbax. The card's machine has no orbax, so the port has its
own on-disk format with the same contract:

* one directory per checkpoint step, ``<dir>/<step>/``, holding each
  quantity's interior and every ``extra`` array as raw bytes, one file
  per array and mesh position (``<key>.<i>.bin``, C order), beside a
  JSON meta record ``meta.json``: the domain's geometry
  (``domain_meta``), each file's shape and dtype, a sha256 digest per
  file (``array_digest``) and the caller's ``meta_extra`` (the
  resilience driver's ``preempted`` tag);
* a save is atomic: the step is written into ``<dir>/.tmp-<step>/``
  and renamed into place once complete, so a crash leaves no
  half-written step (``all_steps`` lists only renamed steps);
* ``max_to_keep`` retention, ``latest_step``, ``all_steps``,
  ``checkpoint_meta``;
* ``restore_domain`` walks back past a corrupt step (unreadable meta,
  a short file, a digest mismatch: ``CorruptCheckpointError``) to the
  next older one, and raises only when none restores;
* bfloat16 round-trips bitwise (its raw 16-bit patterns are stored,
  with the dtype in the meta record: numpy has no bfloat16).

Arrays are per-shard, as the port's state is: ``fields[q]`` and every
extra are lists over the mesh positions (None at another rank's).
``save_arrays``/``restore_arrays`` keep named WHOLE arrays instead (the
serving layer's member checkpoints: global interiors, which restore on
any mesh), with the same digests, rename, retention and walk-back.
Across ranks each rank writes its own shards' files, and rank 0 writes
the meta record once every rank's files are in (the gathers of
``multihost.all_gather_objects`` order them); restore picks ONE step on
every rank — a digest that fails on one rank walks every rank back.

On a card the device-to-host copies run on a side stream after an
event (``ready``) or the current stream's work, so that an async save
of boundary copies never waits for later queued work.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .logging import LOG_WARN
from .retry import retry

META = "meta.json"


class CorruptCheckpointError(RuntimeError):
    """A checkpoint step exists but cannot be trusted (unreadable meta
    record, a missing or short data file, or an integrity-digest
    mismatch)."""


#: directories a domain saved to or restored from (``close_checkpoints``
#: forgets them; the format keeps no open handle between calls)
_KNOWN: set = set()


def close_checkpoints(directory: Optional[str] = None) -> None:
    """Forget ``directory`` (or every directory when None). The JAX
    package closes its cached orbax managers here; the port's
    checkpoints hold no handle, so this only drops the bookkeeping.
    Safe to call repeatedly."""
    if directory is None:
        _KNOWN.clear()
    else:
        _KNOWN.discard(str(Path(directory).absolute()))


# ----------------------------------------------------------------------
# namespace-component hygiene (multi-tenant checkpoint trees)
# ----------------------------------------------------------------------
def validate_checkpoint_component(component: str,
                                  kind: str = "component") -> str:
    """Validate a string that becomes ONE directory component of a
    checkpoint namespace (a tenant or campaign id of the serving layer,
    JAX ``utils/checkpoint.py:52``): an id like ``../other-tenant`` must
    never escape its namespace. Rejects empty strings, path separators
    (``/``, ``\\``), ``.`` and ``..``, NUL and other control characters.
    Returns the component unchanged when valid; raises ``ValueError``
    otherwise."""
    if not isinstance(component, str) or not component:
        raise ValueError(f"{kind} must be a non-empty string, "
                         f"got {component!r}")
    if component in (".", ".."):
        raise ValueError(f"{kind} {component!r} is a path traversal "
                         f"name")
    bad = [ch for ch in component
           if ch in ("/", "\\", "\x00") or ord(ch) < 0x20]
    if bad:
        raise ValueError(f"{kind} {component!r} contains path "
                         f"separators or control characters {bad!r}")
    return component


# ----------------------------------------------------------------------
# host bytes and digests
# ----------------------------------------------------------------------
def dtype_name(dt) -> str:
    """``float32``, ``bfloat16``, ``bool``... for a torch or numpy
    dtype."""
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return str(np.dtype(dt))


def _storage_numpy_dtype(name: str) -> np.dtype:
    # bfloat16 is stored as its 16-bit patterns
    return np.dtype(np.uint16 if name == "bfloat16" else name)


_COPY_STREAMS: Dict[torch.device, Any] = {}


def host_arrays(tensors: Sequence[torch.Tensor],
                ready: Optional[Dict] = None) -> List[np.ndarray]:
    """Host copies of ``tensors`` as numpy arrays (bfloat16 as its uint16
    patterns). CUDA tensors are copied on a side stream of their device,
    after that device's event in ``ready`` (``{device: torch.cuda.Event}``)
    when given, else after the work queued so far on the current stream,
    into pinned memory; the call waits for those copies only."""
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    pending = []
    for k, t in enumerate(tensors):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        if not t.is_cuda:
            out[k] = t.contiguous().numpy()
            continue
        dev = t.device
        side = _COPY_STREAMS.get(dev)
        if side is None:
            side = _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            ev = (ready or {}).get(dev)
            if ev is not None:
                side.wait_event(ev)
            else:
                side.wait_stream(torch.cuda.current_stream(dev))
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        t.record_stream(side)
        pending.append((k, host, done))
    for k, host, done in pending:
        done.synchronize()
        out[k] = host.numpy()
    return out


def _raw(host: np.ndarray) -> memoryview:
    """The bytes of ``host`` in C order, without a copy where possible."""
    return memoryview(np.ascontiguousarray(host).reshape(-1)).cast("B")


def array_digest(arr, dtype: Optional[str] = None) -> str:
    """sha256 over an array's shape, dtype name and raw bytes (JAX
    ``utils/checkpoint.py:159``): the integrity record written next to
    every checkpointed array. ``arr`` is a numpy array or a tensor;
    ``dtype`` overrides the dtype name (the stored bytes of a bfloat16
    tensor are uint16 patterns)."""
    if isinstance(arr, torch.Tensor):
        dtype = dtype or dtype_name(arr.dtype)
        arr = host_arrays([arr])[0]
    host = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(host.shape).encode())
    h.update((dtype or str(host.dtype)).encode())
    h.update(_raw(host))
    return h.hexdigest()


# ----------------------------------------------------------------------
# step directories
# ----------------------------------------------------------------------
def all_steps(directory: str) -> List[int]:
    """Every complete checkpoint step in ``directory``, ascending (a
    step directory with its meta record; temporary directories of an
    unfinished save are not steps)."""
    root = Path(directory)
    if not root.is_dir():
        return []
    return sorted(int(p.name) for p in root.iterdir()
                  if p.name.isdigit() and (p / META).is_file())


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def checkpoint_meta(directory: str, step: Optional[int] = None
                    ) -> Dict[str, Any]:
    """The JSON meta record of checkpoint ``step`` (latest when None) —
    the resilience driver reads the ``preempted`` tag through this
    without reading any array."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    with open(Path(directory) / str(step) / META) as f:
        return json.load(f)


def _file_name(key: str, i: int) -> str:
    return f"{key.replace(':', '-')}.{i}.bin"


def _collective(dd) -> bool:
    mesh = getattr(dd, "mesh", None)
    return bool(mesh is not None and mesh.spans_ranks)


def _gather(dd, obj) -> list:
    """Every rank's ``obj`` (a barrier too) on a mesh over processes;
    ``[obj]`` in one process."""
    if not _collective(dd):
        return [obj]
    from ..parallel.multihost import all_gather_objects

    return all_gather_objects(obj)


def _remove_tree(path: Path) -> None:
    if path.exists():
        trash = path.with_name(f".old-{path.name}-{os.getpid()}")
        os.replace(path, trash)
        shutil.rmtree(trash, ignore_errors=True)


def save_state(dd, directory: str, step: int,
               arrays: Dict[str, Sequence[Optional[torch.Tensor]]],
               meta: Optional[Dict[str, Any]] = None,
               max_to_keep: Optional[int] = None, attempts: int = 3,
               base_delay: float = 0.1, sleep=None, ready=None) -> None:
    """Write ``arrays`` (``key -> one tensor per mesh position``, None
    at other ranks') and the JSON ``meta`` as checkpoint ``step`` of
    ``dd``'s mesh, atomically (see the module docstring). A step that
    exists already (a rolled-back run saves it again) is replaced.
    Transient ``OSError``s are retried with backoff (callers owning
    their own retry loop pass ``attempts=1``)."""
    root = Path(directory)
    tmp = root / f".tmp-{int(step)}"
    rank0 = getattr(getattr(dd, "mesh", None), "rank", 0) == 0

    def prepare():
        root.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()

    if rank0:
        retry(prepare, attempts=attempts, base_delay=base_delay,
              sleep=sleep)
    _gather(dd, None)

    keys, mine = [], []
    for key, shards in arrays.items():
        for i, t in enumerate(shards):
            if t is not None:
                keys.append((key, i, dtype_name(t.dtype)))
                mine.append(t)
    hosts = host_arrays(mine, ready=ready)
    records = {}
    for (key, i, dt), host in zip(keys, hosts):
        name = _file_name(key, i)

        def write(host=host, name=name):
            with open(tmp / name, "wb") as f:
                f.write(_raw(host))

        retry(write, attempts=attempts, base_delay=base_delay, sleep=sleep)
        records[f"{key}.{i}"] = {"file": name, "shape": list(host.shape),
                                 "dtype": dt,
                                 "sha256": array_digest(host, dt)}
    gathered = _gather(dd, records)
    if rank0:
        full = dict(meta or {})
        full["step"] = int(step)
        full["arrays"] = {k: v for part in gathered for k, v in part.items()}

        def publish():
            with open(tmp / META, "w") as f:
                json.dump(full, f, indent=1)
            final = root / str(int(step))
            _remove_tree(final)
            os.replace(tmp, final)

        retry(publish, attempts=attempts, base_delay=base_delay,
              sleep=sleep)
        if max_to_keep is not None:
            for old in all_steps(directory)[:-int(max_to_keep)]:
                _remove_tree(root / str(old))
    _gather(dd, None)


# ----------------------------------------------------------------------
# DistributedDomain integration
# ----------------------------------------------------------------------
def domain_meta(dd) -> Dict[str, Any]:
    return {
        "size": list(dd.size),
        "mesh": list(dd.placement.dim()),
        "quantities": list(dd._names),
        "dtypes": {q: dtype_name(dd._dtypes[q]) for q in dd._names},
    }


def _track_dir(dd, directory: str) -> None:
    """Remember the directories this domain checkpoints into, for
    ``DistributedDomain.close_checkpoints()``."""
    key = str(Path(directory).absolute())
    _KNOWN.add(key)
    dirs = getattr(dd, "_ckpt_dirs", None)
    if dirs is None:
        dirs = dd._ckpt_dirs = set()
    dirs.add(key)


def _interior(dd, t: torch.Tensor, i: int) -> torch.Tensor:
    from ..local_domain import interior_slices

    return t[interior_slices(dd.shard_size(i), dd.alloc_radius)]


def save_domain(dd, directory: str, step: int,
                extra: Optional[Dict[str, Sequence]] = None,
                max_to_keep: Optional[int] = None,
                meta_extra: Optional[Dict[str, Any]] = None,
                attempts: int = 3, base_delay: float = 0.1, sleep=None,
                fields: Optional[Dict[str, Sequence]] = None,
                ready=None) -> None:
    """Checkpoint a ``DistributedDomain``'s ``curr`` fields (each
    shard's interior) plus ``extra`` arrays (per-position tensor lists,
    e.g. RK accumulators or particle lanes) at ``step``, a sha256 per
    file in the meta record. ``meta_extra`` is merged into the meta
    record. ``fields`` overrides the padded source shards (the async save
    passes device copies taken at a segment boundary; ``ready`` is the
    event recorded after those copies)."""
    _track_dir(dd, directory)
    src = dd.curr if fields is None else fields
    arrays = {q: [None if t is None else _interior(dd, t, i)
                  for i, t in enumerate(src[q])] for q in dd._names}
    meta = domain_meta(dd)
    meta["extra"] = {}
    for k, shards in (extra or {}).items():
        arrays[f"extra:{k}"] = list(shards)
        meta["extra"][k] = len(shards)
    for k, v in (meta_extra or {}).items():
        meta[k] = v
    save_state(dd, directory, step, arrays, meta=meta,
               max_to_keep=max_to_keep, attempts=attempts,
               base_delay=base_delay, sleep=sleep, ready=ready)


def _read_own(dd, directory: str, step: int
              ) -> Tuple[Dict[str, Dict[int, np.ndarray]], Dict[str, Any]]:
    """Checkpoint ``step``'s meta record and this rank's arrays, the
    digests verified. Raises ``CorruptCheckpointError`` when the step
    cannot be trusted, ``ValueError`` when it belongs to another domain
    (not corruption: never walked past)."""
    path = Path(directory) / str(step)
    try:
        with open(path / META) as f:
            meta = json.load(f)
    except Exception as e:  # noqa: BLE001 - unreadable -> corrupt
        raise CorruptCheckpointError(
            f"step {step}: meta record unreadable "
            f"({type(e).__name__}: {e})") from e
    if meta.get("size") and list(dd.size) != meta["size"]:
        raise ValueError(f"checkpoint size {meta['size']} != domain "
                         f"{list(dd.size)}")
    if meta.get("quantities") and meta["quantities"] != list(dd._names):
        raise ValueError(f"checkpoint quantities {meta['quantities']} != "
                         f"{list(dd._names)}")
    for q, dt in (meta.get("dtypes") or {}).items():
        if q in dd._dtypes and dtype_name(dd._dtypes[q]) != dt:
            raise ValueError(f"checkpoint dtype {dt} for {q!r} != "
                             f"domain dtype {dd._dtypes[q]}")
    if meta.get("mesh") and meta["mesh"] != list(dd.placement.dim()):
        raise ValueError(f"checkpoint mesh {meta['mesh']} != domain mesh "
                         f"{list(dd.placement.dim())} (the port's "
                         f"checkpoints are per shard)")
    out: Dict[str, Dict[int, np.ndarray]] = {}
    own = set(dd.mesh.local_positions)
    for name, rec in (meta.get("arrays") or {}).items():
        key, i = name.rsplit(".", 1)
        i = int(i)
        if i not in own:
            continue
        try:
            dt = _storage_numpy_dtype(rec["dtype"])
            host = np.fromfile(path / rec["file"], dtype=dt)
            want = int(np.prod(rec["shape"]))
            if host.size != want:
                raise CorruptCheckpointError(
                    f"step {step}: {rec['file']} holds {host.size} of "
                    f"{want} elements")
            host = host.reshape(rec["shape"])
        except CorruptCheckpointError:
            raise
        except Exception as e:  # noqa: BLE001 - missing/short file
            raise CorruptCheckpointError(
                f"step {step}: {rec.get('file')} unreadable "
                f"({type(e).__name__}: {e})") from e
        want = rec.get("sha256")
        if want is not None and array_digest(host, rec["dtype"]) != want:
            raise CorruptCheckpointError(
                f"step {step}: integrity sha256 mismatch for {name} "
                f"(bit-rot or tampering)")
        out.setdefault(key, {})[i] = (host, rec["dtype"])
    return out, meta


def _to_tensor(host: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(host))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def restore_domain(dd, directory: str, step: Optional[int] = None
                   ) -> Tuple[int, Dict[str, List[Optional[torch.Tensor]]]]:
    """Restore a realized ``DistributedDomain``'s ``curr`` fields in
    place (halos zeroed, then one ``exchange()`` fills them); returns
    ``(step, extras)``, each extra a list over the mesh positions on
    their devices (None at other ranks'). The domain must have the
    checkpoint's size, quantities, dtypes and mesh.

    Walks back: when the requested or newest step is corrupt on ANY rank
    a warning is logged and every rank tries the next older one; raises
    ``CorruptCheckpointError`` only when no step restores, and
    ``FileNotFoundError`` when there is none."""
    _track_dir(dd, directory)
    candidates = ([int(step)] if step is not None
                  else sorted(all_steps(directory), reverse=True))
    candidates = _gather(dd, candidates)[0]
    if not candidates:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    found = arrays = meta = None
    last_err = None
    for cand in candidates:
        try:
            got, got_meta = _read_own(dd, directory, cand)
            err = None
        except CorruptCheckpointError as e:
            got, got_meta, err = None, None, str(e)
        errs = [e for e in _gather(dd, err) if e is not None]
        if not errs:
            found, arrays, meta = cand, got, got_meta
            break
        last_err = errs[0]
        LOG_WARN(f"checkpoint {directory} {last_err}; falling back to an "
                 f"older step")
    if found is None:
        raise CorruptCheckpointError(
            f"no restorable checkpoint in {directory} (tried steps "
            f"{candidates}): {last_err}")
    devices = dd.mesh.devices
    for q in dd._names:
        for i, dst in enumerate(dd.curr[q]):
            if dst is None:
                continue
            host, dt = arrays[q][i]
            dst.zero_()
            _interior(dd, dst, i).copy_(_to_tensor(host, dt, dst.device))
    dd.exchange()
    extras = {}
    for k in meta.get("extra") or {}:
        shards = arrays.get(f"extra:{k}", {})
        extras[k] = [_to_tensor(*shards[i], devices[i]) if i in shards
                     else None for i in range(len(devices))]
    return found, extras


# ----------------------------------------------------------------------
# named global arrays (the serving layer's member checkpoints)
# ----------------------------------------------------------------------
def save_arrays(directory: str, step: int, arrays: Dict[str, Any],
                meta: Optional[Dict[str, Any]] = None,
                max_to_keep: Optional[int] = None, attempts: int = 3,
                base_delay: float = 0.1, sleep=None) -> None:
    """Write named WHOLE arrays (numpy arrays or tensors, e.g. one
    member's global interiors) as checkpoint ``step`` of ``directory``:
    one file per name (``<name>.0.bin``), a sha256 per file in the meta
    record, the same atomic rename and ``max_to_keep`` as ``save_state``.
    Nothing in the step depends on a mesh, so it restores onto any
    (JAX's member checkpoints store the same global interiors)."""
    tensors = {k: (v if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(v)))
               for k, v in arrays.items()}
    save_state(None, directory, step, {k: [t] for k, t in tensors.items()},
               meta=meta, max_to_keep=max_to_keep, attempts=attempts,
               base_delay=base_delay, sleep=sleep)


def _read_arrays(directory: str, step: int
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Checkpoint ``step``'s named arrays (``save_arrays``) and meta
    record, each digest verified; ``CorruptCheckpointError`` when the
    step cannot be trusted. bfloat16 comes back as its uint16 patterns
    (the record's ``dtype`` names it)."""
    path = Path(directory) / str(step)
    try:
        with open(path / META) as f:
            meta = json.load(f)
    except Exception as e:  # noqa: BLE001 - unreadable -> corrupt
        raise CorruptCheckpointError(
            f"step {step}: meta record unreadable "
            f"({type(e).__name__}: {e})") from e
    out: Dict[str, np.ndarray] = {}
    for name, rec in (meta.get("arrays") or {}).items():
        key = name.rsplit(".", 1)[0]
        try:
            host = np.fromfile(path / rec["file"],
                               dtype=_storage_numpy_dtype(rec["dtype"]))
            want = int(np.prod(rec["shape"]))
            if host.size != want:
                raise CorruptCheckpointError(
                    f"step {step}: {rec['file']} holds {host.size} of "
                    f"{want} elements")
        except CorruptCheckpointError:
            raise
        except Exception as e:  # noqa: BLE001 - missing/short file
            raise CorruptCheckpointError(
                f"step {step}: {rec.get('file')} unreadable "
                f"({type(e).__name__}: {e})") from e
        host = host.reshape(rec["shape"])
        want = rec.get("sha256")
        if want is not None and array_digest(host, rec["dtype"]) != want:
            raise CorruptCheckpointError(
                f"step {step}: integrity sha256 mismatch for {key} "
                f"(bit-rot or tampering)")
        out[key] = host
    return out, meta


def restore_arrays(directory: str, step: Optional[int] = None
                   ) -> Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]:
    """``(step, arrays, meta)`` of the newest restorable ``save_arrays``
    step in ``directory`` (or ``step``): a corrupt step (unreadable
    meta, a short file, a digest mismatch) is logged and walked past to
    the next older one. Raises ``FileNotFoundError`` when there is no
    step, ``CorruptCheckpointError`` when none restores."""
    candidates = ([int(step)] if step is not None
                  else sorted(all_steps(directory), reverse=True))
    if not candidates:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    last_err = None
    for cand in candidates:
        try:
            arrays, meta = _read_arrays(directory, cand)
        except CorruptCheckpointError as e:
            last_err = e
            LOG_WARN(f"checkpoint {directory} {e}; falling back to an "
                     f"older step")
            continue
        return cand, arrays, meta
    raise CorruptCheckpointError(
        f"no restorable checkpoint in {directory} (tried steps "
        f"{candidates}): {last_err}")
