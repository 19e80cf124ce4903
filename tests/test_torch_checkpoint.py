"""The port's checkpoint format (``stencil_tpu_torch/utils/checkpoint.py``,
its own on-disk layout where the JAX package writes with orbax) held to
the JAX package's contract (``stencil_tpu/utils/checkpoint.py``,
``tests/test_resilience.py``'s checkpoint cases):

* a bitwise round trip of float32, float64 and bfloat16 fields and of
  per-shard ``extra`` arrays, on even and uneven meshes;
* ``max_to_keep`` retention, ``latest_step``/``all_steps``/
  ``checkpoint_meta``;
* ``restore_domain`` walking back past a corrupted (truncated or
  bit-flipped) step, and raising when none restores;
* atomicity: a save killed mid-write (a real SIGKILL of a child
  process) leaves ``latest_step`` unchanged;
* ``TransientSaveFailure`` retried by the save's retry loop;
* the digest itself equals JAX's ``array_digest`` on the same numpy
  array.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.utils.checkpoint import array_digest as j_array_digest
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.resilience import (CheckpointCorruption,
                                          TransientSaveFailure)
from stencil_tpu_torch.utils import checkpoint as ck
from stencil_tpu_torch.utils.retry import retry

DTYPES = [torch.float32, torch.float64, torch.bfloat16]


def _domain(size=(9, 8, 7), n=4, dtype=torch.float32, seed=0):
    pd = DistributedDomain(*size, devices=["cpu"] * n)
    pd.set_radius(1)
    pd.add_data("a", dtype)
    pd.add_data("b", dtype)
    pd.realize()
    rng = np.random.default_rng(seed)
    for q in ("a", "b"):
        pd.set_interior(q, torch.from_numpy(
            rng.standard_normal(size[::-1])).to(dtype))
    return pd


def _ints(t):
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _bits(pd, q):
    return [None if t is None else t.clone() for t in pd.curr[q]]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size,n", [((9, 8, 7), 4), ((16, 16, 16), 8),
                                    ((6, 5, 4), 1)])
def test_round_trip_is_bitwise(tmp_path, dtype, size, n):
    pd = _domain(size, n, dtype)
    pd.exchange()
    want = {q: _bits(pd, q) for q in ("a", "b")}
    extra = {"w": [torch.randn(3, 4, 5).to(dtype) for _ in range(n)],
             "valid": [torch.rand(7) > 0.5 for _ in range(n)]}
    ck.save_domain(pd, str(tmp_path), 3, extra=extra,
                   meta_extra={"preempted": True})
    for q in ("a", "b"):
        for t in pd.curr[q]:
            t.fill_(float("nan"))
    step, got = ck.restore_domain(pd, str(tmp_path))
    assert step == 3
    for q in ("a", "b"):
        for t, w in zip(pd.curr[q], want[q]):
            # interiors and (after restore's exchange) halos, bit for bit
            assert torch.equal(_ints(t), _ints(w))
    for k, v in extra.items():
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got[k], v))
    meta = ck.checkpoint_meta(str(tmp_path))
    assert meta["preempted"] is True and meta["step"] == 3
    assert meta["dtypes"] == {"a": str(dtype).replace("torch.", "")} | {
        "b": str(dtype).replace("torch.", "")}
    assert len(meta["arrays"]) == 2 * n + 2 * n
    assert all(len(r["sha256"]) == 64 for r in meta["arrays"].values())


def test_digest_equals_jax_array_digest():
    for a in (np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              np.linspace(0, 1, 10), np.array([True, False])):
        assert ck.array_digest(a) == j_array_digest(a)
        assert ck.array_digest(torch.from_numpy(a)) == j_array_digest(a)
    b = jnp.arange(16.0, dtype=jnp.float32).reshape(4, 4)
    assert ck.array_digest(np.asarray(b.at[2, 2].set(7.0))) != \
        ck.array_digest(np.asarray(b))


def test_retention_keeps_the_newest(tmp_path):
    pd = _domain()
    for s in (0, 2, 4, 6, 8):
        ck.save_domain(pd, str(tmp_path), s, max_to_keep=3)
    assert ck.all_steps(str(tmp_path)) == [4, 6, 8]
    assert ck.latest_step(str(tmp_path)) == 8
    ck.save_domain(pd, str(tmp_path), 10)           # None keeps all
    ck.save_domain(pd, str(tmp_path), 12)
    assert ck.all_steps(str(tmp_path)) == [4, 6, 8, 10, 12]
    assert sorted(os.listdir(tmp_path)) == ["10", "12", "4", "6", "8"]
    assert ck.latest_step(str(tmp_path / "none")) is None


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_restore_walks_back_past_a_corrupt_step(tmp_path, mode):
    pd = _domain(seed=1)
    ck.save_domain(pd, str(tmp_path), 1)
    want = {q: pd.interior_to_host(q) for q in ("a", "b")}
    pd2 = _domain(seed=2)
    ck.save_domain(pd2, str(tmp_path), 2)
    CheckpointCorruption(step=2, mode=mode).fire(
        str(tmp_path), 2, np.random.default_rng(0), lambda *a, **k: None)
    k = _domain(seed=3)
    step, _ = ck.restore_domain(k, str(tmp_path))
    assert step == 1
    for q in ("a", "b"):
        np.testing.assert_array_equal(k.interior_to_host(q), want[q])


def test_restore_raises_when_none_restores(tmp_path):
    pd = _domain()
    with pytest.raises(FileNotFoundError):
        ck.restore_domain(pd, str(tmp_path))
    ck.save_domain(pd, str(tmp_path), 1)
    (tmp_path / "1" / ck.META).write_text("{not json")
    with pytest.raises(ck.CorruptCheckpointError, match="no restorable"):
        ck.restore_domain(pd, str(tmp_path))


def test_a_mismatched_domain_raises_not_walks_back(tmp_path):
    pd = _domain()
    ck.save_domain(pd, str(tmp_path), 1)
    other = _domain(size=(9, 8, 8))
    with pytest.raises(ValueError, match="size"):
        ck.restore_domain(other, str(tmp_path))
    other = _domain(n=2)
    with pytest.raises(ValueError, match="mesh"):
        ck.restore_domain(other, str(tmp_path))


CHILD = """
import os, signal, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.utils import checkpoint as ck
pd = DistributedDomain(16, 16, 16, devices=["cpu"] * 4)
pd.set_radius(1)
pd.add_data("a")
pd.realize()
ck.save_domain(pd, {d!r}, 1)
raw = ck._raw
calls = []
def dying(host):
    calls.append(1)
    if len(calls) == 3:       # the third file of step 2: die mid-save
        os.kill(os.getpid(), signal.SIGKILL)
    return raw(host)
ck._raw = dying
ck.save_domain(pd, {d!r}, 2)
"""


def test_a_save_killed_mid_write_leaves_latest_step(tmp_path):
    d = str(tmp_path / "ck")
    root = str(Path(__file__).resolve().parent.parent)
    out = subprocess.run([sys.executable, "-c",
                          CHILD.format(root=root, d=d)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -9, out.stderr[-2000:]
    assert ck.latest_step(d) == 1 and ck.all_steps(d) == [1]
    assert (Path(d) / ".tmp-2").is_dir()     # the partial write
    pd = DistributedDomain(16, 16, 16, devices=["cpu"] * 4)
    pd.set_radius(1)
    pd.add_data("a")
    pd.realize()
    assert ck.restore_domain(pd, d)[0] == 1
    ck.save_domain(pd, d, 2)                 # a new save replaces it
    assert ck.all_steps(d) == [1, 2] and not (Path(d) / ".tmp-2").exists()


def test_transient_save_failure_is_retried(tmp_path):
    pd = _domain()
    fault = TransientSaveFailure(step=4, failures=2)
    log, slept = [], []

    def attempt():
        fault.maybe_raise(4, lambda kind, **kw: log.append(kind))
        ck.save_domain(pd, str(tmp_path), 4, attempts=1)

    retry(attempt, attempts=3, base_delay=0.5, sleep=slept.append)
    assert log == ["fault_save_ioerror"] * 2 and slept == [0.5, 1.0]
    assert ck.latest_step(str(tmp_path)) == 4
    fault = TransientSaveFailure(step=4, failures=5)
    with pytest.raises(OSError, match="injected"):
        retry(lambda: fault.maybe_raise(4, lambda *a, **k: None),
              attempts=3, base_delay=0, sleep=lambda s: None)


def test_close_checkpoints_forgets_the_domains_directories(tmp_path):
    pd = _domain()
    ck.save_domain(pd, str(tmp_path / "x"), 1)
    assert str((tmp_path / "x").absolute()) in pd._ckpt_dirs
    assert str((tmp_path / "x").absolute()) in ck._KNOWN
    pd.close_checkpoints()
    assert str((tmp_path / "x").absolute()) not in ck._KNOWN
