"""The port's apps (``stencil_tpu_torch/apps``) against the JAX package's.

Each ported app's ``main()`` runs on the host (``--device cpu`` or
``--devices cpu,cpu,cpu,cpu``) at 16^3 and prints JAX's CSV columns in
JAX's order: the JAX apps (``apps/*.py``) run once, in one subprocess
over 4 fake CPU devices, and every column but the measured seconds and
rates must be equal. ``bench_exchange``'s byte columns equal JAX's
``DistributedDomain.exchange_bytes_total()`` and its JSON the
``_amortized_per_step()`` of the same configuration; with
``--wire-layout`` its ``bench_exchange_layout`` line and the JSON's
``wire_layout_race`` carry the irredundant layout's bytes and their
ratio to the slab layout's, as JAX's do. Options that wait for a
ROADMAP item raise ``NotImplementedError`` naming it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from stencil_tpu.distributed import DistributedDomain as JDomain
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu_torch.apps import (bench_exchange, bench_methods,
                                    bench_pack, bench_qap, exchange_strong,
                                    exchange_weak, jacobi3d,
                                    jacobi3d_strong, machine_info, pingpong)

ROOT = Path(__file__).resolve().parent.parent
CPU4 = ["--devices", "cpu,cpu,cpu,cpu"]
S16 = ["--x", "16", "--y", "16", "--z", "16"]

LAYOUT_RACE = ["--iters", "2", "--exchange-every", "1,2", "--wire-layout",
               "slab,irredundant"]

# case: (JAX argv, port argv, indices of measured columns — per line tag
# where the lines differ)
CASES = {
    "bench_exchange": (S16 + ["--iters", "3", "--exchange-every", "1,2,z=2"],
                       S16 + ["--iters", "3", "--exchange-every", "1,2,z=2"]
                       + CPU4, {12, 13}),
    "bench_exchange_irredundant": (
        S16 + ["--iters", "2", "--wire-layout", "irredundant"],
        S16 + ["--iters", "2", "--wire-layout", "irredundant"] + CPU4,
        {12, 13}),
    "bench_exchange_layout_race": (
        S16 + LAYOUT_RACE, S16 + LAYOUT_RACE + CPU4,
        {"bench_exchange": {12, 13}, "bench_exchange_layout": {5, 7}}),
    "exchange_weak": (S16 + ["--iters", "3"], S16 + ["--iters", "3"] + CPU4,
                      {9, 10, 11}),
    "exchange_strong": (S16 + ["--iters", "3", "--interior-slabs"],
                        S16 + ["--iters", "3", "--interior-slabs"] + CPU4,
                        {9, 10, 11}),
    "jacobi3d_strong": (S16 + ["--iters", "2", "--batch", "1"],
                        S16 + ["--iters", "2", "--batch", "1"] + CPU4,
                        {9, 10, 13}),
    "jacobi3d_strong_random": (
        S16 + ["--iters", "2", "--batch", "1", "--random"],
        S16 + ["--iters", "2", "--batch", "1", "--random"] + CPU4,
        {9, 10, 13}),
    "bench_qap": (["--sizes", "4", "6", "9", "12"],
                  ["--sizes", "4", "6", "9", "12"], {3, 5}),
    "pingpong": (["--min", "10", "--max", "11", "--iters", "2"],
                 ["--min", "10", "--max", "11", "--iters", "2"] + CPU4,
                 {2, 3}),
}
#: the app file of a case whose name is not its app's
CASE_APP = {"bench_exchange_irredundant": "bench_exchange",
            "bench_exchange_layout_race": "bench_exchange",
            "jacobi3d_strong_random": "jacobi3d_strong"}
PORT_APPS = {"bench_exchange": bench_exchange,
             "bench_exchange_irredundant": bench_exchange,
             "bench_exchange_layout_race": bench_exchange,
             "exchange_weak": exchange_weak,
             "exchange_strong": exchange_strong,
             "jacobi3d_strong": jacobi3d_strong,
             "jacobi3d_strong_random": jacobi3d_strong,
             "bench_qap": bench_qap, "pingpong": pingpong}

JAX_RUNNER = """
import contextlib, io, json, runpy, sys
sys.path.insert(0, {apps!r})
cases = json.loads({cases!r})
out = {{}}
for name, (app, argv) in cases.items():
    sys.argv = [app, "--fake-cpu", "4"] + argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path({apps!r} + "/" + app + ".py", run_name="__main__")
    out[name] = buf.getvalue()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(autouse=True)
def no_default_ledger(monkeypatch):
    """A ``--json-out`` run appends to the ledger its test names, never
    to the default one under ``$HOME``."""
    monkeypatch.setenv("STENCIL_BENCH_LEDGER", "")


@pytest.fixture(scope="module")
def jax_lines():
    """Stdout of each JAX app, all run in one process over 4 fake CPU
    devices."""
    cases = json.dumps({k: (CASE_APP.get(k, k), v[0])
                        for k, v in CASES.items()})
    code = JAX_RUNNER.format(apps=str(ROOT / "apps"), cases=cases)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _csv(text):
    return [ln.split(",") for ln in text.strip().splitlines()
            if "," in ln]


@pytest.mark.parametrize("app", sorted(CASES))
def test_app_prints_jax_columns(app, jax_lines, capsys):
    """Same number of lines and columns; every column but the measured
    seconds and rates equal to JAX's, which must parse as numbers."""
    _, argv, measured = CASES[app]
    PORT_APPS[app].main(argv)
    got, want = _csv(capsys.readouterr().out), _csv(jax_lines[app])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        cols = measured.get(w[0], set()) if isinstance(measured, dict) \
            else measured
        for i, (a, b) in enumerate(zip(g, w)):
            if i in cols and a != b:
                float(a), float(b)
            else:
                assert a == b, (app, i, g, w)


def test_bench_exchange_bytes_equal_jax_byte_models(tmp_path, capsys):
    """The deep exchange's bytes (CSV) and their amortized share per
    step (JSON) for ``--exchange-every 1,2,z=2`` at radius (2, 1, 1)."""
    out = tmp_path / "be.json"
    bench_exchange.main(S16 + ["--iters", "2", "--fr", "2", "--er", "1",
                               "--cr", "1", "--fields", "2",
                               "--exchange-every", "1,2,z=2",
                               "--mesh-shape", "1,2,2", "--json-out",
                               str(out)] + CPU4)
    rows = _csv(capsys.readouterr().out)
    payload = json.loads(out.read_text())
    assert [c["exchange_every"] for c in payload["configs"]] == \
        [1, 2, "1.1.2"]
    assert payload["rounds_per_step_ratio"] == {"1": 1.0, "2": 0.5,
                                                "1.1.2": 1.0}
    for s, row, cfg in zip((1, 2, {"z": 2}), rows, payload["configs"]):
        jd = JDomain(16, 32, 32, devices=jax.devices()[:4])
        jd.set_mesh_shape((1, 2, 2))
        jd.set_radius(JRadius.face_edge_corner(2, 1, 1))
        if s != 1:
            jd.set_exchange_every(s)
        for i in range(2):
            jd.add_data(f"q{i}", np.float32)
        jd.realize()
        assert int(row[11]) == jd.exchange_bytes_total()
        assert cfg["bytes_per_exchange_model"] == jd.exchange_bytes_total()
        assert cfg["amortized_bytes_per_step_model"] == \
            jd.exchange_bytes_amortized_per_step()
    assert set(payload) >= {"bench", "mesh", "per_device_size", "radius",
                            "fields", "configs", "baseline_exchange_every",
                            "steps_per_s_ratio", "wire_layout"}


def test_jacobi3d_exchange_every_flag(capsys):
    """``--exchange-every`` takes the temporal path on the padded
    kernels and sets N on the halo path."""
    jacobi3d.main(["--x", "8", "--y", "8", "--z", "8", "--iters", "4",
                   "--batch", "2", "--kernel", "xla", "--mesh-shape",
                   "1,2,2", "--device", "cpu", "--exchange-every", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert line[11] == "xla-temporal[s=2]"
    jacobi3d.main(["--x", "8", "--y", "8", "--z", "8", "--iters", "3",
                   "--batch", "3", "--kernel", "halo", "--mesh-shape",
                   "1,2,2", "--device", "cpu", "--exchange-every", "3"])
    line = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert line[11] == "halo"


@pytest.mark.parametrize("app,argv", [
    (bench_methods, ["--x", "8", "--y", "8", "--z", "8", "--iters", "2"]
     + CPU4),
    (bench_pack, ["--sizes", "8", "16", "--iters", "2", "--device", "cpu"]),
])
def test_app_lines_have_jax_columns(app, argv, capsys):
    """The apps whose JAX twins cannot run here (PallasDMA) or pack
    other regions: JAX's column count and fixed columns."""
    app.main(argv)
    rows = _csv(capsys.readouterr().out)
    if app is bench_methods:
        assert [r[1] for r in rows] == ["PpermuteSlab", "PpermutePacked",
                                        "AllGather", "PallasDMA"]
        assert all(len(r) == 11 and r[2:8] == ["4", "8", "8", "8", "2", "4"]
                   for r in rows)
        assert len({r[8] for r in rows}) == 1          # same bytes
    else:
        assert [r[:4] for r in rows] == [["bench_pack", "8", "2", "4"],
                                         ["bench_pack", "16", "2", "4"]]
        # each direction's halo region, packed and unpacked, 4 fields
        n8 = ((8 + 4) ** 3 - 8 ** 3) * 4 * 4 * 2
        assert all(len(r) == 7 for r in rows) and int(rows[0][4]) == n8


def test_machine_info_lists_the_devices(capsys):
    machine_info.main(["--devices", "cpu,cpu,cpu,cpu"])
    out = capsys.readouterr().out
    assert "devices: 4" in out
    assert "default 3D mesh: (2, 2, 1)" in out


@pytest.mark.parametrize("app,argv,item", [
    (bench_exchange, ["--autotune"], "A12"),
    (bench_exchange, ["--tune-cache", "plans.json"], "A12"),
    (bench_exchange, ["--metrics-json", "m.json"], "A12"),
    (bench_exchange, ["--ledger", "ledger.jsonl"], "A12"),
])
def test_pending_options_raise_naming_their_item(app, argv, item, tmp_path,
                                                 monkeypatch, capsys):
    """The options that waited for ROADMAP ``item`` (A12) now run, each
    writing what JAX's writes: ``--autotune`` the tuned race (CSV line
    and ``autotune`` block), ``--tune-cache`` the plan file,
    ``--metrics-json`` JAX's gauges, ``--ledger`` valid records stamped
    with the link classes."""
    from stencil_tpu_torch.observatory.ledger import (read_ledger,
                                                      validate_ledger)
    from stencil_tpu_torch.telemetry import snapshot_value

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("STENCIL_TUNE_CACHE", str(tmp_path / "env.json"))
    monkeypatch.setenv("STENCIL_BENCH_LEDGER", "")
    extra = ["--autotune"] if argv[0] == "--tune-cache" else []
    app.main(argv + extra + ["--x", "8", "--y", "8", "--z", "8", "--iters",
                             "1", "--json-out", "be.json"] + CPU4)
    payload = json.loads(Path("be.json").read_text())
    rows = _csv(capsys.readouterr().out)
    if argv[0] == "--autotune":
        plan = payload["autotune"]["plan"]
        assert plan["provenance"] == "tuned" and (tmp_path /
                                                  "env.json").exists()
        assert [r for r in rows if r[0] == "bench_exchange_autotune"][0][
            1] == f"{plan['config']['method']}[s=" \
            f"{plan['config']['exchange_every']}]"
    elif argv[0] == "--tune-cache":
        assert Path(argv[1]).exists() and not (tmp_path / "env.json").exists()
    elif argv[0] == "--metrics-json":
        snap = json.loads(Path(argv[1]).read_text())
        assert snapshot_value(snap, "stencil_bench_steps_per_s",
                              exchange_every="1") == \
            payload["configs"][0]["steps_per_s"]
        key = next(iter(payload["link_classes"]))
        axis, klass = key.split("/")
        assert snapshot_value(snap, "stencil_link_bytes_per_step",
                              axis=axis, link_class=klass) == \
            payload["link_classes"][key]["bytes_per_step"]
    else:
        records = read_ledger(argv[1])
        assert validate_ledger(records) == [] and \
            records[0]["bench"] == "bench_exchange"
        assert set(records[0]["config"]["link_classes"]) == \
            set(payload["link_classes"])
        assert item == "A12"


def test_jacobi3d_json_out_ledger_and_tiling(tmp_path, capsys):
    """``jacobi3d --json-out`` (JAX's payload) on a kernel path carries
    the port's tiling record, and its ledger record keys the trajectory
    by JAX's config fingerprint."""
    from stencil_tpu_torch.apps import jacobi3d
    from stencil_tpu_torch.observatory.ledger import (config_fingerprint,
                                                      read_ledger)

    led, out = tmp_path / "l.jsonl", tmp_path / "j.json"
    jacobi3d.main(S16 + ["--iters", "2", "--batch", "1", "--kernel",
                         "pallas", "--json-out", str(out), "--ledger",
                         str(led), "--device", "cpu"])
    payload = json.loads(out.read_text())
    assert payload["tiling_plan"]["jacobi_ring_kernel"]["steps"] == 2
    assert payload["config"] == {"grid": [16, 16, 16], "devices": 1,
                                 "mesh": [1, 1, 1], "kernel": "pallas",
                                 "methods": "PpermuteSlab",
                                 "dtype": "float32", "exchange_every": 1}
    rec = read_ledger(led)[0]
    assert rec["fingerprint"] == config_fingerprint("jacobi3d",
                                                    payload["config"])
    assert rec["config"]["tiling_plan"] == payload["tiling_plan"]
    assert rec["metrics"]["steps_per_s"] > 0


def test_bench_exchange_layout_race_json_matches_jax_bytes(tmp_path, capsys):
    """``wire_layout_race``: the irredundant domain's bytes an exchange
    and their ratio to the slab sweep's, as JAX's domains price them
    (radius 2, one field, four 16^3 shards of (2,2,1))."""
    out = tmp_path / "be.json"
    bench_exchange.main(S16 + LAYOUT_RACE + ["--json-out", str(out)] + CPU4)
    rows = [r for r in _csv(capsys.readouterr().out)
            if r[0] == "bench_exchange_layout"]
    payload = json.loads(out.read_text())
    race = payload["wire_layout_race"]
    assert payload["wire_layout"] == race["baseline_layout"] == "slab"
    assert race["exchange_every"] == 1 and list(race["races"]) == \
        ["irredundant"]
    want = {}
    for layout in ("slab", "irredundant"):
        jd = JDomain(32, 32, 16, devices=jax.devices()[:4])
        jd.set_mesh_shape((2, 2, 1))
        jd.set_radius(JRadius.face_edge_corner(2, 2, 2))
        jd.set_wire_layout(layout)
        jd.add_data("q0", np.float32)
        jd.realize()
        want[layout] = jd.exchange_bytes_total()
    got = race["races"]["irredundant"]
    assert got["bytes_per_exchange_model"] == want["irredundant"]
    assert payload["configs"][0]["bytes_per_exchange_model"] == want["slab"]
    assert got["bytes_ratio"] == want["irredundant"] / want["slab"] < 1
    assert rows == [["bench_exchange_layout", "irredundant", "slab", "1",
                     str(want["irredundant"]), rows[0][5],
                     f"{want['irredundant'] / want['slab']:.4f}",
                     rows[0][7]]]
    assert got["steps_per_s"] > 0 and got["trimean_exchange_s"] > 0


def test_ledger_off_is_accepted(tmp_path, capsys):
    out = tmp_path / "be.json"
    bench_exchange.main(["--x", "8", "--y", "8", "--z", "8", "--iters", "1",
                         "--device", "cpu", "--ledger", "", "--json-out",
                         str(out)])
    assert json.loads(out.read_text())["bench"] == "bench_exchange"


def test_new_modules_import_without_jax():
    """The apps, the temporal engine, the wire-layout planner and the
    precision certificate import neither JAX nor the JAX package (the
    isolation test walks their ASTs; this imports them)."""
    mods = ["stencil_tpu_torch.parallel.temporal",
            "stencil_tpu_torch.parallel.packing",
            "stencil_tpu_torch.analysis.precision"] + [
        f"stencil_tpu_torch.apps.{m}" for m in (
            "bench_exchange", "bench_methods", "bench_pack",
            "exchange_strong", "exchange_weak", "jacobi3d_strong",
            "machine_info", "pingpong")]
    code = (f"import sys, importlib; [importlib.import_module(m) for m in "
            f"{mods!r}]; bad = [m for m in sys.modules if m.split('.')[0] "
            f"in ('jax', 'jaxlib', 'stencil_tpu')]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT),
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr


JAX_RESILIENT = """
import runpy, sys
sys.path.insert(0, {tests!r})
sys.path.insert(0, {apps!r})
from torch_port_support import reference_block_planner
sys.argv = ["jacobi3d.py", "--fake-cpu", "4"] + {argv!r}
with reference_block_planner():
    runpy.run_path({apps!r} + "/jacobi3d.py", run_name="__main__")
"""


@pytest.mark.parametrize("chaos", [["--chaos-nan", "5"],
                                   ["--chaos-halo", "3",
                                    "--chaos-save-fail", "4"]])
def test_jacobi3d_resilient_prints_jax_columns(tmp_path, capsys, chaos):
    """``jacobi3d --resilient`` with seeded faults prints JAX's
    ``jacobi3d-resilient`` line, column for column, and its events JSON
    has JAX's kinds and steps (JAX's observatory events left out; the
    order but for the async checkpoints, ``same_events``); the run also
    writes the plan file under ``--prefix``."""
    argv = S16 + ["--iters", "8", "--resilient", "--ckpt-every", "4",
                  "--kernel", "xla"] + chaos
    code = JAX_RESILIENT.format(
        tests=str(ROOT / "tests"), apps=str(ROOT / "apps"),
        argv=argv + ["--ckpt-dir", str(tmp_path / "jax"), "--events-json",
                     str(tmp_path / "jax.json")])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    want = [ln for ln in out.stdout.splitlines()
            if ln.startswith("jacobi3d-resilient,")]
    jacobi3d.main(argv + ["--ckpt-dir", str(tmp_path / "port"),
                          "--events-json", str(tmp_path / "port.json"),
                          "--prefix", str(tmp_path / "p_")] + CPU4)
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("jacobi3d-resilient,")]
    assert got == want and len(got) == 1

    def kinds(path):
        rec = json.loads(Path(path).read_text())
        return [(e["event"], e.get("step")) for e in rec["events"]
                if not e["event"].startswith("perf_")]

    from torch_port_support import same_events
    assert same_events(kinds(tmp_path / "port.json"),
                       kinds(tmp_path / "jax.json"))
    assert (tmp_path / "p_plan.txt").exists()


def test_astaroth_checkpoint_and_paraview_flags(tmp_path, capsys):
    """``astaroth --checkpoint-dir --checkpoint-every`` saves the state
    (the RK accumulators as extras) as JAX's app does — every crossed
    boundary of N iterations, warm-ups included, and at exit —,
    ``--resume`` starts from the latest, and ``--prefix`` with
    ``--paraview-final`` writes one CSV a shard."""
    from stencil_tpu_torch.apps import astaroth
    from stencil_tpu_torch.utils.checkpoint import all_steps, checkpoint_meta

    d = str(tmp_path / "ck")
    argv = ["--nx", "8", "--ny", "8", "--nz", "8", "--iters", "3",
            "--kernel", "xla", "--device", "cpu", "--checkpoint-dir", d]
    astaroth.main(argv + ["--checkpoint-every", "2", "--prefix",
                          str(tmp_path / "a_"), "--paraview-final"])
    # 2 warm-up and 3 timed iterations: boundaries 2 and 4, then exit 5
    assert all_steps(d) == [2, 4, 5]
    assert set(checkpoint_meta(d)["extra"]) >= {"lnrho", "uux"}
    assert (tmp_path / "a_final0.txt").read_text().startswith(
        "Z,Y,X,lnrho,")
    astaroth.main(argv + ["--resume"])
    assert "# resumed from step 5" in capsys.readouterr().out
    assert all_steps(d)[-1] == 10
