"""The port's particle-in-cell model against the JAX package's.

``stencil_tpu_torch.models.pic.Pic`` (with ``parallel/migrate.py``,
``parallel.exchange.accumulate_shard`` and
``ops.stencil_kernels.central_diff``) against ``stencil_tpu``'s, the
port on CPU shards (``devices=["cpu"] * n``), JAX on the fake CPU mesh.
Tolerances: bitwise where the arithmetic is exact — NGP deposits of
unit charges in float64, and the first CIC step from dyadic initial
conditions at rest (1/8-lattice positions, integer charges, dyadic dt),
where every product and sum is exact whatever the order or contraction
—; after that, CIC within ``rtol = 1e-12`` in float64 of JAX's: the
positions carry more bits than a product of three weights keeps, and
jax's CPU compiler contracts ``a * b + c`` into FMAs in the jitted step
(the gather's ``ex + w * E``, the push's ``v + k q * ex``), which eager
PyTorch does not. The port against itself on two meshes is bitwise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.models.pic import Pic as JPic
from stencil_tpu.models.pic import dense_reference_rho as j_dense_rho
from stencil_tpu.ops.stencil_kernels import central_diff as j_central_diff
from stencil_tpu.parallel.exchange import accumulate_shard as j_accumulate
from stencil_tpu.parallel.mesh import make_mesh as j_make_mesh
from stencil_tpu.parallel.migrate import migrate_shard as j_migrate
from stencil_tpu_torch import Dim3, Radius
from stencil_tpu_torch.convert import pic_state_from_jax
from stencil_tpu_torch.models.pic import (PARTICLE_FIELDS,
                                          PARTICLE_STATE_KEYS, Pic)
from stencil_tpu_torch.ops.stencil_kernels import central_diff
from stencil_tpu_torch.parallel.exchange import WireProbe, accumulate_shard
from stencil_tpu_torch.parallel.migrate import (migrate_shard,
                                                migration_messages,
                                                migration_record_rows)
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")

MESH222 = (2, 2, 2)


def _pics(grid, n, mesh=MESH222, **kw):
    """The JAX model and the port's on the same mesh and settings
    (float64 unless ``dtype`` says otherwise)."""
    kw.setdefault("dtype", np.float64)
    nd = mesh[0] * mesh[1] * mesh[2]
    jp = JPic(*grid, n, mesh_shape=mesh, devices=jax.devices()[:nd], **kw)
    kw["dtype"] = {np.float64: torch.float64,
                   np.float32: torch.float32}[kw["dtype"]]
    pp = Pic(*grid, n, mesh_shape=mesh, devices=["cpu"] * nd, **kw)
    return jp, pp


def _dyadic_ics(n, seed=5):
    """tests/test_pic.py:219's initial conditions: 1/8-lattice positions
    on an 8^3 grid, integer charges, at rest."""
    lat = np.random.default_rng(seed).integers(0, 64, size=(3, n)) / 8.0
    return {"x": lat[0], "y": lat[1], "z": lat[2],
            "vx": np.zeros(n), "vy": np.zeros(n), "vz": np.zeros(n),
            "q": np.arange(1.0, n + 1.0)}


def _uniform_ics(seed, g, n):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(0, g[0], n), "y": rng.uniform(0, g[1], n),
            "z": rng.uniform(0, g[2], n), "vx": np.zeros(n),
            "vy": np.zeros(n), "vz": np.zeros(n), "q": np.ones(n)}


def _assert_same_particles(pp, jp, rtol=0.0):
    """Live particles slot by slot (shard by shard), and overflows."""
    got, want = pp.particles_to_host(), jp.particles_to_host()
    for k in PARTICLE_FIELDS:
        if rtol:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["overflow"], want["overflow"])


# ---------------------------------------------------------------------------
# the building blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_central_diff_matches_jax_bitwise(axis):
    p = np.random.default_rng(81).standard_normal((9, 8, 7))
    jr, pr = JRadius.constant(2), Radius.constant(2)
    want = j_central_diff(jnp.asarray(p), axis, jr, JDim3(4, 5, 6))
    got = central_diff(torch.from_numpy(p), axis, pr, Dim3(4, 5, 6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("grid,nonperiodic", [((9, 8, 7), False),
                                              ((8, 9, 10), True)])
def test_accumulate_shard_matches_jax_bitwise(grid, nonperiodic):
    """The adjoint sweep on (2,2,2) radius-2 shards full of values (pads
    too), uneven (+-1) partitions, periodic and open: every cell of
    every padded shard, JAX's under ``shard_map``."""
    counts = Dim3(*MESH222)
    local = [-(-g // 2) for g in grid]                 # x, y, z
    rem = Dim3(*(g % 2 for g in grid))
    shape = (local[2] + 4, local[1] + 4, local[0] + 4)
    g = np.random.default_rng(82).standard_normal(
        (shape[0] * 2, shape[1] * 2, shape[2] * 2))
    jm = j_make_mesh(MESH222, jax.devices()[:8])
    spec = P("z", "y", "x")
    fn = jax.jit(jax.shard_map(
        lambda a: j_accumulate(a, JRadius.constant(2), JDim3(*MESH222),
                               rem=JDim3(*rem), nonperiodic=nonperiodic),
        mesh=jm, in_specs=spec, out_specs=spec, check_vma=False))
    want = np.asarray(fn(jax.device_put(jnp.asarray(g),
                                        NamedSharding(jm, spec))))
    blocks = []
    for i in range(8):
        x, y, z = i % 2, i // 2 % 2, i // 4
        blocks.append((slice(z * shape[0], (z + 1) * shape[0]),
                       slice(y * shape[1], (y + 1) * shape[1]),
                       slice(x * shape[2], (x + 1) * shape[2])))
    shards = [torch.from_numpy(g[b].copy()) for b in blocks]
    probe = WireProbe()
    accumulate_shard(shards, Radius.constant(2), counts, rem=rem,
                     nonperiodic=nonperiodic, probe=probe)
    for b, t in zip(blocks, shards):
        np.testing.assert_array_equal(t.numpy(), want[b])
    assert len(probe.records) == 6 * 8


def _jax_migrate(fields, valid, offs, budget, cap):
    jm = j_make_mesh(MESH222, jax.devices()[:8])
    spec = P(("z", "y", "x"))

    def shard(f, v, ox, oy, oz):
        f, vv, ovf = j_migrate(f, v, (ox, oy, oz), JDim3(*MESH222), budget)
        return f, vv, ovf.reshape(1)

    specs = {k: spec for k in fields}
    sm = jax.jit(jax.shard_map(
        shard, mesh=jm, in_specs=(specs, spec, spec, spec, spec),
        out_specs=(specs, spec, spec), check_vma=False))
    dev = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                   NamedSharding(jm, spec))
    f, vv, ovf = sm({k: dev(v) for k, v in fields.items()}, dev(valid),
                    *(dev(o) for o in offs))
    return ({k: np.asarray(v) for k, v in f.items()}, np.asarray(vv),
            np.asarray(ovf))


def _migrate_case(name, cap=8):
    """(fields, valid, offsets, budget) over 8 shards of ``cap`` slots:
    tests/test_pic.py's routing, wrap, budget and capacity cases, and a
    random mix under both pressures."""
    n = 8 * cap
    q = np.zeros(n)
    w = np.zeros(n)
    valid = np.zeros(n, bool)
    ox, oy, oz = (np.zeros(n, np.int32) for _ in range(3))
    budget = 4
    if name == "route":      # a stayer, a +x face hop, a corner hop
        valid[0:3] = True
        q[0:3] = [10.0, 11.0, 12.0]
        ox[1] = 1
        ox[2] = oy[2] = oz[2] = 1
    elif name == "wrap":     # -x from shard 0 wraps to the last x shard
        valid[0] = True
        q[0] = 5.0
        ox[0] = -1
    elif name == "budget":   # six leavers, budget 4: two dropped
        valid[0:6] = True
        q[0:6] = np.arange(1.0, 7.0)
        ox[0:6] = 1
    elif name == "capacity":  # a full receiver drops both arrivals
        valid[cap:2 * cap] = True
        q[cap:2 * cap] = 100.0
        valid[0:2] = True
        q[0:2] = [1.0, 2.0]
        ox[0:2] = 1
    else:                    # random offsets, 3/4 full, budget 2
        rng = np.random.default_rng(83)
        valid = rng.random(n) < 0.75
        q = rng.standard_normal(n)
        w = rng.standard_normal(n)
        ox, oy, oz = (rng.integers(-1, 2, n).astype(np.int32)
                      for _ in range(3))
        budget = 2
    return {"q": q, "w": w}, valid, (ox, oy, oz), budget


@pytest.mark.parametrize("case", ["route", "wrap", "budget", "capacity",
                                  "random"])
def test_migrate_shard_matches_jax(case):
    """Every slot of every lane, the validity masks and the overflow
    counts of one migration equal JAX's, on (2,2,2): face, edge and
    corner routing, the periodic wrap, and drops under budget and
    capacity pressure."""
    cap = 8
    fields, valid, offs, budget = _migrate_case(case, cap)
    wf, wv, wo = _jax_migrate(fields, valid, offs, budget, cap)

    def split(a):
        return [torch.from_numpy(np.asarray(a[i * cap:(i + 1) * cap]))
                for i in range(8)]

    probe = WireProbe()
    gf, gv, go = migrate_shard(
        {k: split(v) for k, v in fields.items()}, split(valid),
        list(zip(*(split(o) for o in offs))), Dim3(*MESH222), budget,
        probe=probe)
    for k in fields:
        np.testing.assert_array_equal(torch.cat(gf[k]).numpy(), wf[k],
                                      err_msg=k)
    np.testing.assert_array_equal(torch.cat(gv).numpy(), wv)
    np.testing.assert_array_equal(torch.stack(go).numpy(), wo[:, 0]
                                  if wo.ndim == 2 else wo)
    assert len(probe.records) == migration_messages(Dim3(*MESH222)) * 8
    if case == "budget":
        assert wo.sum() == 2
    if case == "capacity":
        assert wo.sum() == 2


def test_message_and_record_counts():
    assert migration_messages(Dim3(2, 2, 2)) == 6
    assert migration_messages(Dim3(1, 2, 1)) == 2
    assert migration_messages(Dim3(1, 1, 1)) == 0
    assert migration_record_rows(7) == 8


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid", [(8, 8, 8), (9, 9, 9)])
def test_ngp_total_charge_is_exact_on_any_mesh(grid):
    """NGP float64 of unit charges: after each of 5 steps the total
    deposited charge equals the particle count bitwise, on (1,1,1) and
    (2,2,2) (uneven +-1 shards at 9^3); the first step's rho equals
    JAX's dense oracle bitwise."""
    n = 48
    ics = _uniform_ics(3, grid, n)
    for mesh in ((1, 1, 1), MESH222):
        nd = mesh[0] * mesh[1] * mesh[2]
        p = Pic(*grid, n, mesh_shape=mesh, devices=["cpu"] * nd,
                dtype=torch.float64, deposition="ngp")
        p.set_particles(ics)
        p.step()
        np.testing.assert_array_equal(p.rho(), j_dense_rho(
            ics["x"], ics["y"], ics["z"], ics["q"], grid,
            deposition="ngp"))
        totals = [p.total_charge()]
        for _ in range(4):
            p.step()
            totals.append(p.total_charge())
        assert totals == [float(n)] * 5
        assert p.overflow_total() == 0


@pytest.mark.parametrize("mesh", [(1, 1, 1), MESH222])
def test_dyadic_cic_matches_jax(mesh):
    """CIC with dyadic ICs, on one shard and on (2,2,2): after the first
    step (exact arithmetic) the particles, slot by slot, and rho equal
    JAX's bitwise; after the second, within rtol 1e-12."""
    ics = _dyadic_ics(16)
    jp, pp = _pics((8, 8, 8), 16, mesh, deposition="cic")
    jp.set_particles(ics)
    pp.set_particles(ics)
    jp.step()
    pp.step()
    _assert_same_particles(pp, jp)
    np.testing.assert_array_equal(pp.rho(), jp.rho())
    jp.step()
    pp.step()
    _assert_same_particles(pp, jp, rtol=1e-12)
    np.testing.assert_allclose(pp.rho(), jp.rho(), rtol=0, atol=1e-12)


def test_dyadic_cic_is_bitwise_across_meshes():
    """tests/test_pic.py's property on the port: after 2 CIC steps from
    dyadic ICs the particles (sorted) and rho on (1,1,1) and (2,2,2)
    agree bitwise."""
    out = {}
    for mesh in ((1, 1, 1), MESH222):
        nd = mesh[0] * mesh[1] * mesh[2]
        p = Pic(8, 8, 8, 16, mesh_shape=mesh, devices=["cpu"] * nd,
                dtype=torch.float64, deposition="cic")
        p.set_particles(_dyadic_ics(16))
        p.run(2)
        h = p.particles_to_host()
        order = np.lexsort((h["z"], h["y"], h["x"], h["q"]))
        out[mesh] = ({k: h[k][order] for k in PARTICLE_FIELDS}, p.rho())
    for k in PARTICLE_FIELDS:
        np.testing.assert_array_equal(out[(1, 1, 1)][0][k],
                                      out[MESH222][0][k], err_msg=k)
    np.testing.assert_array_equal(out[(1, 1, 1)][1], out[MESH222][1])


def test_random_cic_within_tolerance_of_jax():
    """JAX's seeded ``init()`` (uniform plasma, thermal velocities) on an
    uneven 9^3 grid over (2,2,2), CIC float64, 3 steps: the same
    particles land in the same slots, within rtol 1e-12 of JAX's, and
    rho within 1e-12 (the jitted step contracts into FMAs)."""
    jp, pp = _pics((9, 9, 9), 60, deposition="cic", seed=7)
    jp.run(3)
    pp.run(3)
    _assert_same_particles(pp, jp, rtol=1e-12)
    np.testing.assert_allclose(pp.rho(), jp.rho(), rtol=0, atol=1e-12)
    with reference_block_planner():
        assert pp.migration_stats() == jp.migration_stats()


def test_overflow_counts_match_jax_under_budget_pressure():
    """Every particle crosses the same +x face in one step with budget
    1: the per-shard overflow counts (and the survivors) equal JAX's."""
    n = 24
    ics = _uniform_ics(3, (8, 8, 8), n)
    ics["x"] = np.full(n, 3.9)
    ics["vx"] = np.full(n, 1.0)
    jp, pp = _pics((8, 8, 8), n, deposition="ngp", budget=1, seed=1)
    jp.set_particles(ics)
    pp.set_particles(ics)
    jp.step()
    pp.step()
    assert pp.overflow_total() == jp.overflow_total() > 0
    _assert_same_particles(pp, jp)


def test_one_step_sends_18_messages_a_shard():
    """On (2,2,2) a step sends 6 accumulate, 6 exchange and 6 migration
    messages a shard, counted in the port's engines."""
    p = Pic(8, 8, 8, 40, mesh_shape=MESH222, devices=["cpu"] * 8,
            dtype=torch.float64)
    p.probe = WireProbe()
    p.step()
    assert len(p.probe.records) == 18 * 8
    assert {r[0] for r in p.probe.records} == {"x", "y", "z"}


def test_state_from_jax_round_trips_and_continues():
    """``pic_state_from_jax`` carries a JAX model's state (after a step)
    into the port bit for bit; a step of each then agrees within rtol
    1e-12 (dyadic ICs; the second step is not exact)."""
    jp, pp = _pics((8, 8, 8), 16, deposition="cic")
    jp.set_particles(_dyadic_ics(16, seed=9))
    jp.step()
    state = {k: np.asarray(v) for k, v in jp.state.items()}
    pp.load_state(pic_state_from_jax(state, pp.dd, jp.capacity))
    for k in PARTICLE_STATE_KEYS:
        np.testing.assert_array_equal(
            torch.cat(pp.state[k]).numpy(), state[k], err_msg=k)
    np.testing.assert_array_equal(pp.rho(), jp.rho())
    jp.step()
    pp.step()
    _assert_same_particles(pp, jp, rtol=1e-12)
    np.testing.assert_allclose(pp.rho(), jp.rho(), rtol=0, atol=1e-12)


def test_deferred_hooks_name_their_queue_items(tmp_path, monkeypatch):
    """``run_resilient`` runs (a clean campaign: bitwise the plain run,
    the particle lanes checkpointed as extras); the perf-model hooks,
    once deferred to A12, equal JAX's (``Pic.perf_model_step_seconds``
    and ``perf_model_bytes_per_step``) with both packages' default link
    priced alike (their defaults differ: H100 against TPU), and are None
    on one shard, as JAX's."""
    p = Pic(8, 8, 8, 16, mesh_shape=(1, 1, 1), devices=["cpu"],
            dtype=torch.float64, deposition="ngp")
    q = Pic(8, 8, 8, 16, mesh_shape=(1, 1, 1), devices=["cpu"],
            dtype=torch.float64, deposition="ngp")
    from stencil_tpu_torch.resilience import ResiliencePolicy
    from stencil_tpu_torch.utils.checkpoint import checkpoint_meta

    rep = p.run_resilient(2, policy=ResiliencePolicy(
        check_every=1, ckpt_every=1, sleep=lambda s: None),
        ckpt_dir=str(tmp_path))
    q.run(2)
    assert rep.steps == 2 and rep.rollbacks == 0 and rep.fused
    _assert_same_particles(p, q)
    np.testing.assert_array_equal(p.rho(), q.rho())
    assert set(checkpoint_meta(str(tmp_path))["extra"]) == \
        set(PARTICLE_STATE_KEYS)
    assert p.perf_model_step_seconds() is None
    from stencil_tpu_torch.analysis import costmodel as pcm

    link = (2e-6, 3e10)
    monkeypatch.setattr(pcm, "DEFAULT_ICI_COEFFS",
                        pcm.LinkCoefficients(*link))
    for dep, dtype in (("ngp", np.float64), ("cic", np.float32)):
        jp, pp = _pics((16, 8, 8), 64, (2, 2, 2), deposition=dep,
                       dtype=dtype)
        with reference_block_planner():
            from stencil_tpu.analysis import costmodel as jcm

            monkeypatch.setattr(jcm, "DEFAULT_ICI_COEFFS",
                                jcm.LinkCoefficients(*link))
            want = (jp.perf_model_step_seconds(),
                    jp.perf_model_bytes_per_step())
        got = (pp.perf_model_step_seconds(), pp.perf_model_bytes_per_step())
        assert got[0] == pytest.approx(want[0], rel=1e-12) and got[0] > 0
        assert got[1] == want[1] > 0
    with pytest.raises(NotImplementedError):
        from stencil_tpu_torch import Method

        Pic(8, 8, 8, 16, mesh_shape=(1, 1, 1), devices=["cpu"],
            methods=Method.AllGather)


@pytest.mark.parametrize("case", [("cic", np.float32, 16, 16384),
                                  ("cic", np.float32, 32, 131072),
                                  ("ngp", np.float64, 16, 16384)])
def test_total_charge_equals_jax_exactly(case):
    """C1: ``total_charge`` is the model dtype's ``np.sum`` of ``rho()``,
    as JAX's — exactly JAX's value for CIC float32 (16^3 with 16,384
    particles and 32^3 with 131,072, seed 7, one step), where a float64
    sum of the shard sums differed, and for NGP float64."""
    dep, dtype, g, n = case
    jp, pp = _pics((g, g, g), n, (1, 1, 1), dtype=dtype, deposition=dep,
                   seed=7)
    jp.step()
    pp.step()
    np.testing.assert_array_equal(pp.rho(), jp.rho())
    assert pp.total_charge() == jp.total_charge()
    assert pp.total_charge() == float(np.sum(pp.rho(), dtype=dtype))


def test_entry_point_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        Pic(8, 8, 8, 16)


JAX_APP = """
import runpy, sys
sys.path.insert(0, {tests!r})
sys.path.insert(0, {apps!r})
from torch_port_support import reference_block_planner
sys.argv = ["pic.py", "--fake-cpu", "4", "--no-fuse-segments"] + {argv!r}
with reference_block_planner():
    runpy.run_path({app!r}, run_name="__main__")
"""


def test_app_prints_jax_columns(capsys, tmp_path):
    """``apps/pic.py`` on four CPU shards prints JAX's CSV line: every
    column but the three measured ones (min, trimean, particle steps/s)
    equal to JAX's app on four fake CPU devices (both without the
    segment race, ``tests/test_torch_megastep_apps.py``'s); the options
    that wait for A11 and A12 raise naming them."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from stencil_tpu_torch.apps import pic as app

    root = Path(__file__).resolve().parent.parent
    argv = ["--iters", "2", "--batch", "1", "--particles", "64"]
    code = JAX_APP.format(tests=str(root / "tests"), apps=str(root / "apps"),
                          argv=argv,
                          app=str(root / "apps" / "pic.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(root), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    want = [ln for ln in out.stdout.splitlines() if ln.startswith("pic,")]
    app.main(argv + ["--no-fuse-segments", "--devices", "cpu,cpu,cpu,cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("pic,")]
    assert len(got) == len(want) == 1
    g, w = got[0].split(","), want[0].split(",")
    assert len(g) == len(w) == 13
    for i, (a, b) in enumerate(zip(g, w)):
        if i in (8, 9, 10):
            float(a), float(b)
        else:
            assert a == b, (i, g, w)
    # --metrics-json and --ledger, once deferred to A12: JAX's gauges,
    # and a valid ledger record of the same numbers
    from stencil_tpu_torch.observatory.ledger import (read_ledger,
                                                      validate_ledger)
    from stencil_tpu_torch.telemetry import snapshot_value

    d = tmp_path
    app.main(argv + ["--no-fuse-segments", "--device", "cpu",
                     "--metrics-json", str(d / "m.json"), "--ledger",
                     str(d / "l.jsonl"), "--json-out", str(d / "p.json")])
    snap = json.loads((d / "m.json").read_text())
    rec = json.loads((d / "p.json").read_text())
    assert snapshot_value(snap, "stencil_bench_particle_steps_per_s",
                          deposition="cic") == rec["particle_steps_per_s"]
    led = read_ledger(d / "l.jsonl")
    assert validate_ledger(led) == [] and led[0]["bench"] == "pic"
    assert led[0]["metrics"]["steps_per_s"] == 1.0 / rec["seconds_per_step"]


def test_app_resilient_chaos_nan_prints_jax_columns(tmp_path, capsys):
    """``apps/pic.py --resilient --chaos-nan 3`` prints JAX's
    ``pic-resilient`` line: every column equal to JAX's app on four fake
    CPU devices, and the events JSON has JAX's kinds and steps."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from stencil_tpu_torch.apps import pic as app

    root = Path(__file__).resolve().parent.parent
    argv = ["--iters", "6", "--particles", "64", "--resilient",
            "--chaos-nan", "3", "--ckpt-every", "2"]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    code = JAX_APP.format(tests=str(root / "tests"), apps=str(root / "apps"),
                          argv=argv + ["--ckpt-dir", str(jdir),
                                       "--events-json",
                                       str(tmp_path / "jax.json")],
                          app=str(root / "apps" / "pic.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(root), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    want = [ln for ln in out.stdout.splitlines()
            if ln.startswith("pic-resilient,")]
    app.main(argv + ["--no-fuse-segments", "--ckpt-dir", str(pdir),
                     "--events-json", str(tmp_path / "port.json"),
                     "--devices", "cpu,cpu,cpu,cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("pic-resilient,")]
    assert got == want and len(got) == 1

    def kinds(path):
        rec = json.loads(Path(path).read_text())
        return [(e["event"], e.get("step")) for e in rec["events"]
                if not e["event"].startswith(("perf_", "fused_"))]

    from torch_port_support import same_events
    assert same_events(kinds(tmp_path / "port.json"),
                       kinds(tmp_path / "jax.json"))
