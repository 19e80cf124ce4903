"""The apps' segment options against the JAX package's apps:
``bench_exchange --fuse-segments --check-every`` (three races: Jacobi,
PIC, Astaroth's temporal path), ``astaroth --fuse-segments
--check-every`` (and its decline on a kernel path) and ``pic`` (the race
on by default).

The JAX apps (``apps/*.py``) run once, in one subprocess over 4 fake
CPU devices; the port's ``main()`` on ``--devices cpu,cpu,cpu,cpu`` at
8^3 a shard. Every column but the measured seconds and rates must be
equal (exact: they are the tag, the configuration, the path, the
modeled bytes and counts); the measured ones must parse as positive
numbers. Segments of one step keep the JAX side's compiles short (its
MHD segments unroll every substep); the segments themselves are held
against JAX in ``test_torch_megastep*.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from stencil_tpu_torch.apps import astaroth, bench_exchange, pic

ROOT = Path(__file__).resolve().parent.parent
CPU4 = ["--devices", "cpu,cpu,cpu,cpu"]
S8 = ["--x", "8", "--y", "8", "--z", "8"]

#: case: (app, argv for both, measured columns per line tag)
CASES = {
    "bench_exchange": (
        bench_exchange,
        S8 + ["--iters", "2", "--fuse-segments", "--check-every", "1"],
        {"bench_exchange": {12, 13},
         "bench_exchange_megastep_jacobi": {3, 4, 5},
         "bench_exchange_megastep_pic": {3, 4, 5},
         "bench_exchange_megastep_astaroth": {3, 4, 5},
         "bench_exchange_megastep": {3, 4, 5}}),
    "astaroth": (
        astaroth,
        ["--nx", "8", "--ny", "8", "--nz", "8", "--iters", "2", "--kernel",
         "xla", "--exchange-every", "2", "--fuse-segments", "--check-every",
         "1"],
        {None: {4, 5}}),
    "pic": (pic, ["--iters", "4", "--fuse-check-every", "2"],
            {"pic": {8, 9, 10}, "pic-megastep": {3, 4, 5}}),
}

JAX_RUNNER = """
import contextlib, io, json, runpy, sys
import jax.core as jc, jax.extend.core as jec
for name in ("Jaxpr", "ClosedJaxpr", "Literal", "Var"):
    try:
        getattr(jc, name)
    except AttributeError:
        setattr(jc, name, getattr(jec, name))
sys.path.insert(0, {apps!r})
cases = json.loads({cases!r})
out = {{}}
for name, argv in cases.items():
    sys.argv = [name, "--fake-cpu", "4"] + argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path({apps!r} + "/" + name + ".py", run_name="__main__")
    out[name] = buf.getvalue()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_lines():
    """Stdout of each JAX app, all run in one process over 4 fake CPU
    devices (the JAX package's resilience import reads
    ``jax.core.Jaxpr``: the runner lends jax.extend's, as
    ``torch_port_support.reference_block_planner`` does)."""
    cases = json.dumps({k: v[1] for k, v in CASES.items()})
    code = JAX_RUNNER.format(apps=str(ROOT / "apps"), cases=cases)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=400, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _csv(text):
    return [ln.split(",") for ln in text.strip().splitlines()
            if "," in ln and not ln.startswith("#")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_options_print_jax_columns(case, jax_lines, capsys):
    app, argv, measured = CASES[case]
    app.main(argv + CPU4)
    got, want = _csv(capsys.readouterr().out), _csv(jax_lines[case])
    assert [g[0] for g in got] == [w[0] for w in want] and got
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        skip = measured.get(g[0], measured.get(None, set()))
        for i, (a, b) in enumerate(zip(g, w)):
            if i in skip:
                assert float(a) > 0 and float(b) > 0, (i, g, w)
            else:
                assert a == b, (i, g, w)


def test_astaroth_segments_decline_on_a_kernel_path(capsys):
    """``--fuse-segments`` on ``wrap``: the decline's reason on stderr,
    the per-iteration loop, the path in the line."""
    astaroth.main(["--nx", "16", "--ny", "16", "--nz", "16", "--iters", "1",
                   "--kernel", "wrap", "--fuse-segments", "--device",
                   "cpu"])
    cap = capsys.readouterr()
    assert "declined on the 'wrap' path" in cap.err
    assert "interior-resident" in cap.err
    assert _csv(cap.out)[0][6] == "wrap"
