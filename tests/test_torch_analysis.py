"""The port's graftcheck (``agilerl_tpu_torch.analysis``) against the JAX
package's: both engines on the same language-neutral fixtures give the same
findings and fingerprints (GX003 numpy/stdlib, GX004, GX005, pragma scopes,
fingerprints, the baseline round trip, the CLI's exit codes); each torch
spelling of a rule has a positive and a negative fixture
(``tests/fixtures/analysis_torch/``); and the port package is clean against
its committed baseline (``analysis_baseline_torch.json``), with GX003 and
GX005 at zero without it."""

import json
import pathlib
import subprocess
import sys

import pytest

from agilerl_tpu_torch.analysis import (
    BASELINE_FILENAME,
    analyze,
    discover_baseline,
    load_baseline,
    split_baselined,
    write_baseline,
)
from agilerl_tpu_torch.analysis.__main__ import main as cli_main
from agilerl_tpu_torch.analysis.pragmas import parse_pragmas

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "agilerl_tpu_torch"
BASELINE = REPO / "analysis_baseline_torch.json"
JAX_FIXTURES = REPO / "tests" / "fixtures" / "analysis"
FIXTURES = REPO / "tests" / "fixtures" / "analysis_torch"

#: the rules whose catalogue carries no torch spelling on the JAX fixtures
NEUTRAL = ["GX003", "GX004", "GX005"]


def _jax():
    pytest.importorskip("jax")
    import agilerl_tpu.analysis as JA

    return JA


def _keys(findings):
    return [(f.rule, f.path, f.line, f.fingerprint) for f in findings]


@pytest.fixture(scope="module")
def package_report():
    return analyze([PACKAGE])


# --------------------------------------------------------------------------- #
# Both engines on the same fixtures
# --------------------------------------------------------------------------- #


def test_neutral_rules_match_the_jax_engine_on_its_fixtures():
    JA = _jax()
    want = JA.analyze([JAX_FIXTURES], select=NEUTRAL)
    got = analyze([JAX_FIXTURES], select=NEUTRAL)
    assert _keys(got.findings) == _keys(want.findings)
    assert got.suppressed == want.suppressed and got.files_scanned == want.files_scanned
    assert {f.rule for f in got.findings} == set(NEUTRAL)


@pytest.mark.parametrize("rule,path,n", [
    ("GX003", "gx003_pos.py", 6),
    ("GX004", "resilience/gx004_pos.py", 4),
    ("GX004", "parallel/compile_cache.py", 3),
    ("GX005", "gx005_pos.py", 3),
])
def test_jax_positive_fixtures_fire_in_the_port_engine(rule, path, n):
    found = [f for f in analyze([JAX_FIXTURES], select=[rule]).findings if f.path == path]
    assert [f.rule for f in found] == [rule] * n
    assert all(f.message and f.hint and f.text and f.fingerprint for f in found)


@pytest.mark.parametrize("path", ["gx003_neg.py", "resilience/gx004_neg.py", "gx005_neg.py"])
def test_jax_negative_fixtures_stay_clean_in_the_port_engine(path):
    assert [f for f in analyze([JAX_FIXTURES]).findings if f.path == path] == []


def test_pragma_fixture_suppressed_alike():
    """The JAX spelling ``# graftcheck: disable=GXnnn`` works unchanged: the
    JAX pragma fixture is clean in both engines, with the same count."""
    JA = _jax()
    got, want = analyze([JAX_FIXTURES]), JA.analyze([JAX_FIXTURES])
    assert not any("pragma_fixture" in f.path for f in got.findings)
    assert got.suppressed == want.suppressed >= 5
    src = "x = 1  # graftcheck: disable=GX001, gx004\n# graftcheck: disable-file=GX003\n"
    assert parse_pragmas(src) == JA.pragmas.parse_pragmas(src) == ({1: {"GX001", "GX004"}},
                                                                   {"GX003"})


def _write(root, rel, text):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return p


def test_pragma_scopes_match_the_jax_engine(tmp_path):
    """A body pragma does not silence a compound header; a header pragma
    does; a GX001 pragma leaves a GX003 finding on the same line."""
    JA = _jax()
    _write(tmp_path, "resilience/snap.py",
           "import os\n"
           "def save(state, path):\n"
           "    with open(path, 'w') as fh:\n"
           "        fh.write(state)\n"
           "        os.replace(path, path)  # graftcheck: disable=GX004\n"
           "    with open(path, 'w') as fh:  # graftcheck: disable=GX004\n"
           "        fh.write(state)\n")
    _write(tmp_path, "training/mixed.py",
           "import numpy as np\n"
           "def f(xs):\n"
           "    for x in xs:\n"
           "        a = np.asarray(np.random.normal())  # graftcheck: disable=GX001\n"
           "    return a\n")
    got, want = analyze([tmp_path]), JA.analyze([tmp_path])
    assert _keys(got.findings) == _keys(want.findings)
    assert [(f.rule, f.text) for f in got.findings] == [
        ("GX004", "with open(path, 'w') as fh:"),
        ("GX003", "a = np.asarray(np.random.normal())  # graftcheck: disable=GX001")]
    assert got.suppressed == want.suppressed == 3


def test_fingerprints_equal_the_jax_engine_and_survive_drift(tmp_path):
    JA = _jax()
    body = ("import numpy as np\n\n"
            "def f(xs):\n"
            "    for x in xs:\n"
            "        a = np.asarray(x)\n"
            "        b = np.asarray(x)\n"
            "    return a, b\n")
    mod = _write(tmp_path, "training/twice.py", body)
    first = analyze([tmp_path]).findings
    assert _keys(first) == _keys(JA.analyze([tmp_path]).findings)
    assert len(first) == 2 and first[0].fingerprint != first[1].fingerprint
    mod.write_text("# a new leading comment\n" + body)
    second = analyze([tmp_path]).findings
    assert [f.fingerprint for f in second] == [f.fingerprint for f in first]
    assert [f.line for f in second] == [f.line + 1 for f in first]


def test_baseline_round_trip_matches_the_jax_engine(tmp_path):
    JA = _jax()
    mod = _write(tmp_path, "pkg/training/loop.py",
                 "import numpy as np\n"
                 "def f(xs):\n"
                 "    for x in xs:\n"
                 "        a = np.asarray(x)\n"
                 "    return a\n")
    pkg = tmp_path / "pkg"
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    write_baseline(ours, analyze([pkg]).findings)
    JA.write_baseline(theirs, JA.analyze([pkg]).findings)
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    baseline = load_baseline(ours)
    mod.write_text("# drift\n" + mod.read_text().replace(
        "    return a\n", "        b = float(x)\n    return a, b\n"))
    new, accepted, stale = split_baselined(analyze([pkg]).findings, baseline)
    jnew, jacc, jstale = JA.split_baselined(JA.analyze([pkg]).findings, baseline)
    assert _keys(new) == _keys(jnew) and _keys(accepted) == _keys(jacc) and stale == jstale
    assert [f.text for f in new] == ["b = float(x)"] and len(accepted) == 1
    mod.write_text(mod.read_text().replace("        a = np.asarray(x)\n", "        a = x\n"))
    _, accepted, stale = split_baselined(analyze([pkg]).findings, baseline)
    assert accepted == [] and [e["text"] for e in stale] == ["a = np.asarray(x)"]


def test_cli_exit_codes_and_json_match_the_jax_cli(tmp_path, capsys):
    from agilerl_tpu.analysis.__main__ import main as jax_cli

    _jax()
    _write(tmp_path, "pkg/training/loop.py",
           "import numpy as np\n"
           "def f(xs):\n"
           "    for x in xs:\n"
           "        a = np.asarray(x)\n"
           "    return a\n")
    pkg = str(tmp_path / "pkg")
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")

    def both(args, ours_args=None):
        a = cli_main(ours_args if ours_args is not None else args)
        out_a = capsys.readouterr().out
        b = jax_cli(args)
        out_b = capsys.readouterr().out
        return a, b, out_a, out_b

    a, b, out_a, out_b = both([pkg, "--no-baseline", "--format", "json"])
    assert a == b == 1
    pa, pb = json.loads(out_a), json.loads(out_b)
    assert pa["by_rule"] == pb["by_rule"] == {"GX001": 1}
    assert [f["fingerprint"] for f in pa["findings"]] == [f["fingerprint"] for f in pb["findings"]]
    assert both([pkg, "--no-baseline"])[:2] == (1, 1)
    assert both([pkg, "--baseline", theirs, "--write-baseline"],
                [pkg, "--baseline", ours, "--write-baseline"])[:2] == (0, 0)
    a, b, out_a, out_b = both([pkg, "--baseline", theirs], [pkg, "--baseline", ours])
    assert (a, b) == (0, 0) and "1 baselined" in out_a and "1 baselined" in out_b
    assert both([pkg, "--no-baseline", "--disable", "GX001"])[:2] == (0, 0)
    assert both([pkg, "--baseline", ours, "--select", "GX002", "--write-baseline"])[:2] == (2, 2)
    assert both([pkg, "--select", "GX999"])[:2] == (2, 2)
    a, b, out_a, _ = both(["--list-rules"])
    assert (a, b) == (0, 0) and all(f"GX00{i}" in out_a for i in range(1, 6))


def test_port_cli_never_discovers_the_jax_baseline(tmp_path, capsys):
    """A tree holding only the JAX package's ``analysis_baseline.json``
    gives the port's CLI no baseline: its finding fails the run."""
    JA = _jax()
    _write(tmp_path, "pkg/training/loop.py",
           "import numpy as np\n"
           "def f(xs):\n"
           "    return [np.asarray(x) for x in xs]\n")
    JA.write_baseline(tmp_path / "analysis_baseline.json", JA.analyze([tmp_path / "pkg"]).findings)
    assert BASELINE_FILENAME == "analysis_baseline_torch.json"
    assert discover_baseline(tmp_path / "pkg") is None
    assert cli_main([str(tmp_path / "pkg")]) == 1
    write_baseline(tmp_path / BASELINE_FILENAME, analyze([tmp_path / "pkg"]).findings)
    capsys.readouterr()
    assert cli_main([str(tmp_path / "pkg")]) == 0
    assert "1 baselined" in capsys.readouterr().out
    assert discover_baseline(PACKAGE) == BASELINE


# --------------------------------------------------------------------------- #
# The torch spellings: one positive and one negative fixture per rule
# --------------------------------------------------------------------------- #

CASES = {
    "GX001": ("training/gx001_torch_pos.py", 10, "training/gx001_torch_neg.py"),
    "GX002": ("gx002_torch_pos.py", 5, "gx002_torch_neg.py"),
    "GX003": ("gx003_torch_pos.py", 8, "gx003_torch_neg.py"),
    "GX004": ("resilience/gx004_torch_pos.py", 4, "resilience/gx004_torch_neg.py"),
    "GX005": ("gx005_torch_pos.py", 3, "gx005_torch_neg.py"),
}


@pytest.fixture(scope="module")
def torch_fixture_report():
    return analyze([FIXTURES])


@pytest.mark.parametrize("rule", sorted(CASES))
def test_torch_positive_fixture_triggers_rule(rule, torch_fixture_report):
    pos, expected, _ = CASES[rule]
    found = [f for f in torch_fixture_report.findings if f.path == pos]
    assert [f.rule for f in found] == [rule] * expected, [(f.rule, f.line, f.text) for f in found]
    for f in found:
        assert f.message and f.hint and f.text and f.fingerprint


@pytest.mark.parametrize("rule", sorted(CASES))
def test_torch_negative_fixture_stays_clean(rule, torch_fixture_report):
    neg = CASES[rule][2]
    assert [f for f in torch_fixture_report.findings if f.path == neg] == []


def test_gx001_reports_a_cpu_chain_once_and_only_in_hot_modules(tmp_path):
    src = (FIXTURES / "training" / "gx001_torch_pos.py").read_text()
    line = [f for f in analyze([FIXTURES], select=["GX001"]).findings
            if "detach().cpu().numpy()" in f.text]
    assert len(line) == 1 and ".cpu()" in line[0].message
    cold = _write(tmp_path, "cold_module.py", src)
    assert analyze([cold]).findings == []


def test_gx002_does_not_flag_jax_jit_in_the_port(tmp_path):
    """The port's GX002 reads torch's compilers; a jax.jit in a loop is the
    JAX package's rule."""
    mod = _write(tmp_path, "loop.py",
                 "import jax\n"
                 "def f(fns):\n"
                 "    return [jax.jit(fn) for fn in fns]\n")
    assert analyze([mod], select=["GX002"]).findings == []


# --------------------------------------------------------------------------- #
# The port package against its committed baseline
# --------------------------------------------------------------------------- #


def test_port_package_has_zero_unbaselined_findings(package_report):
    assert not package_report.errors, package_report.errors
    new, _, _ = split_baselined(package_report.findings, load_baseline(BASELINE))
    assert new == [], "\n".join(f.render() for f in new)


def test_port_baseline_has_no_stale_entries(package_report):
    _, _, stale = split_baselined(package_report.findings, load_baseline(BASELINE))
    assert stale == [], [e["text"] for e in stale]


def test_port_gx003_and_gx005_clean_without_baseline():
    assert analyze([PACKAGE], select=["GX003", "GX005"]).findings == []


def test_port_baseline_carries_only_gx001(package_report):
    """Every baselined finding is a host sync at collect / learn /
    generation cadence (GX001); the membership lease writes carry their
    GX004 pragmas, as in the JAX package."""
    assert {e["rule"] for e in load_baseline(BASELINE).values()} == {"GX001"}
    assert not any(f.rule == "GX004" for f in package_report.findings)


def test_port_cli_exits_zero_in_a_process_without_jax():
    """``python -m agilerl_tpu_torch.analysis`` against the committed
    baseline, in a fresh process that must not load jax."""
    code = ("import runpy, sys\n"
            "sys.argv = ['graftcheck']\n"
            "try:\n"
            "    runpy.run_module('agilerl_tpu_torch.analysis', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'agilerl_tpu'))\n"
            "    print(e.code, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "0 []", out.stdout
