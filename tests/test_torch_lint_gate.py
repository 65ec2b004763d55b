"""The port's lint gate: ``nomad_tpu_torch/lint`` over ``nomad_tpu_torch/``.

The tree is clean against the committed baseline
(``nomad_tpu_torch/lint/baseline.json``), every entry of which names a
port path and carries a ``why``; the loader's hygiene (duplicate keys and
unsorted entries are load errors) and the ratchet (suppressed and stale
entries) are the reference's; ``python -m nomad_tpu_torch.lint`` and
``python -m nomad_tpu_torch.cli lint`` keep the reference's output
contract and exit codes (0 clean, 1 with a new finding).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from nomad_tpu_torch.lint import (
    BASELINE_PATH,
    Baseline,
    Finding,
    load_baseline,
    repo_root,
    run_all,
    split_baselined,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, cwd=None):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, cwd=cwd or ROOT, env=env, timeout=120)


def test_repo_root_finds_the_port():
    root = repo_root()
    assert os.path.isdir(os.path.join(root, "nomad_tpu_torch"))
    assert os.path.realpath(root) == os.path.realpath(ROOT)


@pytest.fixture(scope="module")
def findings():
    """Every pass over the port's tree, once for the file."""
    return run_all()


def test_port_tree_is_clean_against_its_baseline(findings):
    new, suppressed, stale = split_baselined(findings, load_baseline())
    assert new == [], [f.render() for f in new]
    assert stale == [], stale
    assert {f.rule for f in suppressed} <= {"L003", "H001"}


def test_committed_baseline_names_port_paths_with_reasons():
    bl = load_baseline()
    assert bl.entries
    for e in bl.entries:
        assert e["path"].startswith("nomad_tpu_torch/"), e
        assert os.path.exists(os.path.join(ROOT, e["path"])), e
        assert len(e.get("why", "")) > 20, e
    assert BASELINE_PATH.endswith(
        os.path.join("nomad_tpu_torch", "lint", "baseline.json"))


def _entries(*keys):
    return {"exemptions": [
        {"rule": r, "path": p, "symbol": s, "why": "w"} for r, p, s in keys]}


@pytest.mark.parametrize("keys,error", [
    ((("L003", "a.py", "f"), ("L003", "a.py", "f")), "duplicate"),
    ((("L003", "b.py", "f"), ("L003", "a.py", "f")), "sorted"),
])
def test_baseline_hygiene_errors(tmp_path, keys, error):
    p = tmp_path / "b.json"
    p.write_text(json.dumps(_entries(*keys)))
    with pytest.raises(ValueError, match=error):
        load_baseline(str(p))


def test_suppression_and_stale_reporting():
    f1 = Finding("L003", "a.py", 10, "C.m", "x")
    f2 = Finding("L001", "b.py", 20, "D.n", "y")
    bl = Baseline(entries=[
        {"rule": "L003", "path": "a.py", "symbol": "C.m", "why": "ok"},
        {"rule": "L004", "path": "z.py", "symbol": "E.o", "why": "gone"},
    ])
    new, suppressed, stale = split_baselined([f1, f2], bl)
    assert [f.rule for f in new] == ["L001"]
    assert [f.rule for f in suppressed] == ["L003"]
    assert [e["rule"] for e in stale] == ["L004"]
    # Symbol keying survives line churn.
    assert bl.match(Finding("L003", "a.py", 999, "C.m", "x")) is not None


def _lint_main(kind):
    if kind == "module":
        from nomad_tpu_torch.lint.__main__ import main

        return main
    from nomad_tpu_torch.cli import main as cli_main

    return lambda argv: cli_main(["lint"] + argv)


@pytest.mark.parametrize("kind", ["module", "cli"])
def test_lint_exit_codes(tmp_path, capsys, monkeypatch, findings, kind):
    """0 on the tree with its baseline (the last line says clean); 1 with
    an empty baseline, each new finding printed as ``path:line: RULE
    [symbol] msg``; ``-v`` lists what the baseline suppressed; a stale
    entry alone does not fail the run.  The passes' findings are the
    tree's, computed once (``findings``)."""
    import nomad_tpu_torch.lint.__main__ as lint_main

    monkeypatch.setattr(lint_main, "run_all", lambda root=None: list(findings))
    main = _lint_main(kind)
    assert main([]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1].startswith("nomad lint: clean")

    empty = tmp_path / "empty.json"
    empty.write_text('{"exemptions": []}')
    assert main(["--baseline", str(empty)]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("nomad lint: 9 new finding(s)")
    assert any(": L003 [journaled.wrapper] " in ln for ln in lines)
    assert any(": H001 [place_task_group] " in ln for ln in lines)

    assert main(["-v"]) == 0
    assert "-- baseline suppressed 9 finding(s):" in capsys.readouterr().out

    stale = tmp_path / "stale.json"
    with open(BASELINE_PATH) as fh:
        data = json.load(fh)
    data["exemptions"].append({"rule": "L004", "path": "nomad_tpu_torch/x.py",
                               "symbol": "gone", "why": "a stale entry"})
    stale.write_text(json.dumps(data))
    assert main(["--baseline", str(stale)]) == 0
    assert "-- stale baseline entry" in capsys.readouterr().out


def test_lint_process_exit_code(tmp_path):
    """``python -m nomad_tpu_torch.lint`` from outside the repository, as
    a process: every pass runs and its exit code is the gate's (1 with an
    empty baseline; 0 with the committed one is held in process)."""
    empty = tmp_path / "empty.json"
    empty.write_text('{"exemptions": []}')
    out = _run("nomad_tpu_torch.lint", "--baseline", str(empty),
               cwd=str(tmp_path))
    assert out.returncode == 1, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith(
        "nomad lint: 9 new finding(s)")
