"""Persistent plan cache: fingerprint-keyed tuned plans on disk.

PyTorch-port counterpart of ``stencil_tpu/tuning/cache.py``. One JSON
file holds every plan this machine has tuned, keyed by the problem
fingerprint (``tuning/plan.fingerprint``). A later run with a matching
fingerprint skips measurement; a miss re-tunes. A file of another schema
version, or a corrupt or truncated one, is ignored with a warning (the
tuner then re-tunes and rewrites it), never trusted and never fatal.

Location: ``$STENCIL_TUNE_CACHE`` when set, else
``~/.cache/stencil_tpu_torch/plans.json`` (the JAX package's default is
``~/.cache/stencil_tpu/plans.json``; the two never share a file by
default).

Concurrency: ``store_plan`` and ``invalidate_plan`` read, merge and
write under an exclusive ``flock`` on a ``<cache>.lock`` sidecar plus a
per-path mutex, so two writers storing different fingerprints both
land; the publish is a temporary file renamed over the cache, so
readers, who take no lock, see the old or the new file, never half of
one.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Union

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: thread lock only
    fcntl = None

from ..utils.logging import LOG_DEBUG, LOG_WARN
from ..utils.retry import retry
from .plan import SCHEMA_VERSION, Plan

ENV_CACHE = "STENCIL_TUNE_CACHE"

# transient-I/O retry budget for cache reads and writes; tests inject a
# fake clock through _RETRY_SLEEP
_RETRY_ATTEMPTS = 3
_RETRY_BASE_DELAY = 0.05
_RETRY_SLEEP = None  # None -> time.sleep


def default_cache_path() -> Path:
    env = os.environ.get(ENV_CACHE, "")
    if env:
        return Path(env)
    return Path(os.path.expanduser(
        "~/.cache/stencil_tpu_torch/plans.json"))


def _resolve(path: Union[str, Path, None]) -> Path:
    return Path(path) if path is not None else default_cache_path()


def load_cache(path: Union[str, Path, None] = None) -> Dict[str, Dict]:
    """The raw fingerprint -> plan-record table, or {} when the file is
    absent, unreadable, corrupt, or of another schema version."""
    p = _resolve(path)
    if not p.exists():
        return {}
    try:
        text = retry(p.read_text, attempts=_RETRY_ATTEMPTS,
                     base_delay=_RETRY_BASE_DELAY, sleep=_RETRY_SLEEP)
        data = json.loads(text)
    except (OSError, ValueError) as e:
        LOG_WARN(f"plan cache {p} is corrupt or unreadable "
                 f"({type(e).__name__}: {e}); "
                 f"ignoring it (will re-tune and rewrite)")
        return {}
    if not isinstance(data, dict) or "plans" not in data:
        LOG_WARN(f"plan cache {p} has no 'plans' table; ignoring it")
        return {}
    schema = data.get("schema")
    if schema != SCHEMA_VERSION:
        LOG_WARN(f"plan cache {p} has schema {schema!r}, this library "
                 f"speaks {SCHEMA_VERSION}; ignoring it (will re-tune)")
        return {}
    plans = data["plans"]
    return dict(plans) if isinstance(plans, dict) else {}


def load_plan(fingerprint: str,
              path: Union[str, Path, None] = None) -> Optional[Plan]:
    """The cached plan for ``fingerprint``, or None (a miss, a bad file,
    or a record that does not parse)."""
    rec = load_cache(path).get(fingerprint)
    if rec is None:
        return None
    try:
        plan = Plan.from_record(rec)
    except (KeyError, TypeError, ValueError) as e:
        LOG_WARN(f"cached plan for {fingerprint[:12]}... does not parse "
                 f"({type(e).__name__}: {e}); treating as a miss")
        return None
    if plan.fingerprint != fingerprint:
        LOG_WARN(f"cached plan under key {fingerprint[:12]}... carries "
                 f"mismatched fingerprint {plan.fingerprint[:12]}...; "
                 f"treating as a miss")
        return None
    return plan


# in-process serialization per cache path: flock excludes other
# processes, and threads of one process sharing the lock file need this
# too
_PATH_LOCKS: Dict[str, threading.Lock] = {}
_PATH_LOCKS_GUARD = threading.Lock()


def _thread_lock_for(p: Path) -> threading.Lock:
    key = str(p.absolute())
    with _PATH_LOCKS_GUARD:
        lock = _PATH_LOCKS.get(key)
        if lock is None:
            lock = _PATH_LOCKS[key] = threading.Lock()
        return lock


@contextlib.contextmanager
def _write_lock(p: Path):
    """Exclusive writer lock for the file ``p``: a ``flock`` on the
    ``<p>.lock`` sidecar (never the data file, whose inode the publish
    replaces) plus an in-process per-path mutex."""
    with _thread_lock_for(p):
        if fcntl is None:  # pragma: no cover - non-POSIX
            yield
            return
        lock_path = p.with_name(p.name + ".lock")
        fd = os.open(lock_path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)


def publish_json(p: Path, payload: Dict) -> None:
    """Atomically publish ``payload`` at ``p``: a temporary file in the
    same directory, renamed over it."""
    fd, tmp = tempfile.mkstemp(dir=str(p.parent),
                               prefix=p.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _mutate_cache(p: Path, mutate) -> None:
    """Read, ``mutate(plans)`` in place and publish, under
    ``_write_lock`` with transient-I/O retry; ``mutate`` returns False
    to abandon the write."""

    def mutate_once():
        with _write_lock(p):
            plans = load_cache(p)
            if mutate(plans) is False:
                return
            publish_json(p, {"schema": SCHEMA_VERSION, "plans": plans})

    retry(mutate_once, attempts=_RETRY_ATTEMPTS,
          base_delay=_RETRY_BASE_DELAY, sleep=_RETRY_SLEEP)


def store_plan(plan: Plan, path: Union[str, Path, None] = None) -> Path:
    """Insert or replace ``plan`` under its fingerprint."""
    p = _resolve(path)
    p.parent.mkdir(parents=True, exist_ok=True)

    def merge(plans):
        plans[plan.fingerprint] = plan.to_record()

    _mutate_cache(p, merge)
    LOG_DEBUG(f"plan cache {p}: stored {plan.config.key()} under "
              f"{plan.fingerprint[:12]}...")
    return p


def invalidate_plan(fingerprint: str,
                    path: Union[str, Path, None] = None) -> bool:
    """Drop the cached record of ``fingerprint`` so the next tune
    re-measures: the observatory's drift hook
    (``ResiliencePolicy.retune_on_drift``). True when a record was
    removed."""
    p = _resolve(path)
    if not p.exists():
        return False
    removed = False

    def drop(plans):
        nonlocal removed
        if fingerprint not in plans:
            return False
        del plans[fingerprint]
        removed = True

    _mutate_cache(p, drop)
    if removed:
        LOG_WARN(f"plan cache {p}: invalidated "
                 f"{fingerprint[:12]}... (perf drift — the next tune "
                 f"re-measures)")
    return removed
