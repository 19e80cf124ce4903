"""The port's analysis checkers (``stencil_tpu_torch.analysis``): the
registry clean on the CPU, the CLI's exit codes, selection and JSON
artifact (as ``tests/test_lint.py`` holds JAX's), every JAX registry
target covered by a port target of the same name or a ``NO_COUNTERPART``
reason, and a negative control a checker under
``tests/fixtures/torch_lint/`` on which the CLI exits nonzero.

JAX's registry is read for its target names only, inside
``torch_port_support.reference_modules`` (jax 0.9 moved the
``jax.core`` names its analysis package reads); none of its checkers
runs here.
"""

import json
from pathlib import Path

import pytest

from stencil_tpu_torch.analysis import CHECKER_DOC, CHECKERS, run_targets
from stencil_tpu_torch.analysis import registry
from stencil_tpu_torch.analysis.__main__ import main
from stencil_tpu_torch.analysis.report import Finding, Report
from torch_port_support import reference_modules

FIXTURES = Path(__file__).parent / "fixtures" / "torch_lint"


@pytest.fixture(scope="module")
def full_report():
    """One run of every registered target (``cuda.`` ones skip here)."""
    return run_targets(registry.default_targets())


@pytest.fixture(scope="module")
def jax_names():
    with reference_modules():
        from stencil_tpu.analysis import registry as jreg

        return {t.name: t.checker for t in jreg.default_targets()}


def test_registry_is_clean_on_the_cpu(full_report):
    assert full_report.ok, [str(f) for f in full_report.errors]
    names = full_report.targets_checked
    assert len(names) == len(set(names)) == len(registry.default_targets())
    # every non-card target ran its checker and left metrics
    for name in names:
        if name.startswith("cuda."):
            continue
        assert any(k.endswith(":" + name) for k in full_report.metrics), name
    # the cuda. group skips here with a metric that says why
    skipped = [m for k, m in full_report.metrics.items()
               if k.split(":", 1)[1].startswith("cuda.")]
    assert skipped and all("sm_90" in m["skipped"] for m in skipped)
    assert set(full_report.checker_seconds) == set(CHECKERS)


def test_every_warning_cites_a_roadmap_item(full_report):
    """A known break of an invariant is a warning that cites the ROADMAP
    item recording it, never a silent pass."""
    roadmap = (Path(__file__).parent.parent / "ROADMAP.md").read_text()
    for f in full_report.warnings:
        assert "ROADMAP N" in f.message, str(f)
        item = f.message.split("ROADMAP ")[1].split(")")[0]
        assert f"{item}." in roadmap, item


def test_jax_names_are_covered(jax_names):
    port = {t.name: t.checker for t in registry.default_targets()}
    missing = [n for n in jax_names
               if n not in port and n not in registry.NO_COUNTERPART]
    assert not missing, missing
    assert not set(port) & set(registry.NO_COUNTERPART)
    assert all(reason.strip() for reason in registry.NO_COUNTERPART.values())
    assert set(registry.NO_COUNTERPART) <= set(jax_names)
    # a counterpart is checked by the checker of the same name
    assert all(port[n] == c for n, c in jax_names.items() if n in port)
    # the port's own targets beyond JAX's are the card group
    assert all(n.startswith("cuda.") for n in set(port) - set(jax_names))


def test_checkers_are_jax_checkers():
    assert CHECKERS == ("footprint", "dma", "collectives", "hlo",
                        "costmodel", "vmem", "donation", "transfer",
                        "recompile", "tiling", "linkmap", "schedule",
                        "precision")
    assert set(CHECKER_DOC) == set(CHECKERS)


def test_cli_exit_codes_and_json(tmp_path):
    out = tmp_path / "report.json"
    rc = main(["-q", "--json", str(out), str(FIXTURES / "bad_collective.py")])
    assert rc == 1
    data = json.loads(out.read_text())
    assert data["schema_version"] == 2
    assert data["tool"] == "stencil-lint"
    assert data["tool_version"] and data["torch_version"]
    assert data["device"] == "cpu"
    assert data["counts"]["errors"] >= 2
    assert data["counts"]["errors_by_checker"] == {
        "collectives": data["counts"]["errors"]}
    assert set(data["checker_seconds"]) == {"collectives"}
    assert {f["severity"] for f in data["findings"]} == {"error"}
    assert all(set(f) == {"checker", "target", "message", "severity"}
               for f in data["findings"])


def test_cli_list_and_only(capsys, tmp_path):
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in CHECKERS:
        assert name in out
    assert "registry targets by group" in out
    for group in ("ops", "parallel", "tuning", "serving", "telemetry",
                  "resilience", "models", "cuda"):
        assert group in out
    assert "donation=" in out and "recompile=" in out
    report = tmp_path / "r.json"
    rc = main(["-q", "--only", "vmem", "--json", str(report),
               str(FIXTURES / "bad_vmem.py")])
    assert rc == 1
    data = json.loads(report.read_text())
    assert set(data["checker_seconds"]) == {"vmem"}
    assert {f["checker"] for f in data["findings"]} == {"vmem"}
    assert any(k.startswith("vmem:fixture.") for k in data["metrics"])


def test_cli_only_accepts_target_globs(tmp_path):
    report = tmp_path / "r.json"
    rc = main(["-q", "--only", "fixture.collectives.send_*", "--json",
               str(report), str(FIXTURES / "bad_collective.py")])
    assert rc == 1
    data = json.loads(report.read_text())
    assert data["targets_checked"] == [
        "fixture.collectives.send_without_receive"]
    # composed to nothing: a vacuously green run is refused
    assert main(["-q", "--only", "fixture.collectives.*", "--only", "vmem",
                 str(FIXTURES / "bad_collective.py")]) == 2
    # composed to something
    assert main(["-q", "--only", "fixture.collectives.*", "--only",
                 "collectives", str(FIXTURES / "bad_collective.py")]) == 1
    # literal brackets in the registry's names
    report2 = tmp_path / "r2.json"
    assert main(["-q", "--only", "analysis.schedule.*[k=4]", "--json",
                 str(report2)]) == 0
    data2 = json.loads(report2.read_text())
    assert data2["counts"]["targets"] >= 4
    assert all("k=4]" in t for t in data2["targets_checked"])
    # a glob matching nothing is a usage error, also beside one that does
    assert main(["-q", "--only", "no.such.target.*",
                 str(FIXTURES / "bad_collective.py")]) == 2
    assert main(["-q", "--only", "fixture.collectives.*", "--only",
                 "no.such.target.*",
                 str(FIXTURES / "bad_collective.py")]) == 2


def test_cli_plan_tiling(capsys, tmp_path):
    out = tmp_path / "plans.json"
    assert main(["--plan-tiling", "*laplace6*", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "laplace6_pallas[256]" in text and "B8" in text
    plans = json.loads(out.read_text())["plans"]
    assert [p["kernel"] for p in plans] == ["B8", "B8"]
    assert main(["--plan-tiling", "no.such.*"]) == 2


FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("bad_*.py"))


def test_a_negative_control_for_every_checker():
    """At least one fixture a checker, each failing that checker."""
    covered = set()
    for name in FIXTURE_FILES:
        for t in registry.load_targets(FIXTURES / name):
            covered.add(t.checker)
    assert covered == set(CHECKERS)


@pytest.mark.parametrize("fixture", FIXTURE_FILES)
def test_cli_nonzero_on_every_fixture(fixture, tmp_path):
    """The CLI exits nonzero on each negative control, and every target
    of the fixture has an error of its own checker."""
    out = tmp_path / "r.json"
    assert main(["-q", "--json", str(out), str(FIXTURES / fixture)]) == 1
    data = json.loads(out.read_text())
    for name in data["targets_checked"]:
        assert any(f["target"] == name and f["severity"] == "error"
                   for f in data["findings"]), name


def test_cli_usage_error_on_missing_fixture(tmp_path):
    assert main(["-q", str(tmp_path / "nope.py")]) == 2


def test_report_json_roundtrip():
    r = Report()
    r.targets_checked.append("t")
    r.findings.append(Finding("dma", "t", "boom"))
    d = json.loads(r.to_json())
    assert d["counts"] == {"targets": 1, "errors": 1, "warnings": 0,
                           "errors_by_checker": {"dma": 1}}
    assert not r.ok


def test_probed_matrix_refuses_positions_outside_the_mesh():
    """A message recorded with a position outside ``range(n)`` (a -1
    where a caller left a position out) is an error, not a byte on the
    last position's link."""
    from stencil_tpu_torch.observatory.linkmap import probed_matrix

    w = probed_matrix([("z", 0, 1, 8), ("y", 1, 0, 4)], 2)
    assert w.tolist() == [[0, 8], [4, 0]]
    for src, dst in ((-1, 0), (0, -1), (2, 0)):
        with pytest.raises(ValueError, match="outside"):
            probed_matrix([("z", src, dst, 8)], 2)
