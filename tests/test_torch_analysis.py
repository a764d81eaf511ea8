"""The port's lint pass (``repro_torch.analysis``), held against the
reference's ``repro.analysis``.

* Each rule both packages have gives the reference rule's findings (path,
  line, column, rule) on the reference's own fixtures
  (``tests/analysis_fixtures/``, read in place).
* ``host-sync-in-hot-path`` in torch terms fires on each host round-trip
  of a bad file written to ``tmp_path`` and stays silent on its good twin.
* ``# repro: noqa[rule]`` and the count-matched baseline behave as the
  reference's.
* The port's tree is clean modulo ``tools/analysis_baseline_torch.json``;
  the CLI's exit codes are the reference's (0 clean, 1 findings, 2 usage).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
from repro_torch.analysis import (AnalysisContext, Finding, all_rules,
                                  apply_baseline, default_context,
                                  load_baseline, run_analysis,
                                  write_baseline)

HERE = Path(__file__).resolve().parent
FIXTURES = HERE / "analysis_fixtures"
REPO = HERE.parent
SHARED = ("host-sync-in-hot-path", "sharding-axis", "hint-drift",
          "event-schema-drift", "knob-doc-drift")


def _loc(res):
    return sorted((f.path, f.line, f.col, f.rule) for f in res.findings)


def _file_case(name):
    files = (FIXTURES / name,)
    return (AnalysisContext(root=FIXTURES, files=files),
            ref_analysis.AnalysisContext(root=FIXTURES, files=files))


def _repo_case(kind, which):
    if kind == "hint-drift":
        tree = FIXTURES / f"hint_drift_{which}"
        kw = dict(hints_path=tree / "hints.py", models_dir=tree / "models")
        root = tree
    elif kind == "event-schema-drift":
        kw = dict(fleet_path=FIXTURES / f"event_schema_{which}.py")
        root = FIXTURES
    else:
        tree = FIXTURES / f"knob_doc_{which}"
        kw = dict(launch_dir=tree / "launch", knobs_md=tree / "knobs.md")
        root = tree
    return (AnalysisContext(root=root, files=(), **kw),
            ref_analysis.AnalysisContext(root=root, files=(), **kw))


CASES = [(r, _file_case, f"{stem}_{w}.py")
         for r, stem in (("host-sync-in-hot-path", "host_sync"),
                         ("sharding-axis", "sharding_axis"))
         for w in ("bad", "good")]
CASES += [(r, _repo_case, w)
          for r in ("hint-drift", "event-schema-drift", "knob-doc-drift")
          for w in ("bad", "good")]


@pytest.mark.parametrize("rule_name,make,arg", CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_shared_rule_finds_what_the_reference_finds(rule_name, make, arg):
    if make is _repo_case:
        port_ctx, ref_ctx = make(rule_name, arg)
    else:
        port_ctx, ref_ctx = make(arg)
    got = run_analysis(port_ctx, rule_names=[rule_name])
    want = ref_analysis.run_analysis(ref_ctx, rule_names=[rule_name])
    assert _loc(got) == _loc(want)
    if "bad" in arg:
        assert got.findings


def test_registry_leaves_out_the_jit_rules():
    assert set(all_rules()) == set(SHARED)
    assert {"donation-after-use", "retrace-hazard"} <= set(
        ref_analysis.all_rules())


BAD_TORCH = '''\
import numpy as np
import torch


def decode_tick(self, logits, loss, buf):
    a = logits.argmax(-1).item()                    # 1
    b = buf.cpu()                                   # 2
    c = buf.tolist()                                # 3
    d = buf.numpy()                                 # 4
    e = float(loss)                                 # 5
    f = int(logits[0, 0])                           # 6
    g = bool(loss > 0)                              # 7
    torch.cuda.synchronize()                        # 8
    h = np.asarray(torch.argmax(logits, -1))        # 9
    return a, b, c, d, e, f, g, h


def _tick(self, ints):
    return ints.sum().item()                        # 10
'''

GOOD_TORCH = '''\
import numpy as np
import torch


def decode_tick(self, toks, lanes):
    n = int(toks.shape[0]) + int(toks.size(1)) + toks.numel()
    host = toks.cpu().numpy()  # repro: noqa[host-sync-in-hot-path] one D2H
    nxt = host[:lanes]
    pos = np.zeros(4, dtype=np.int32)
    return [int(nxt[i]) + int(pos[i]) for i in range(4)], n


def not_hot(self, loss):
    torch.cuda.synchronize()
    return float(loss), loss.item()
'''


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return path


def test_torch_host_sync_bad_fires_on_every_round_trip(tmp_path):
    path = _write(tmp_path, "hot.py", BAD_TORCH)
    res = run_analysis(AnalysisContext(root=tmp_path, files=(path,)),
                       rule_names=["host-sync-in-hot-path"])
    lines = BAD_TORCH.splitlines()
    marked = sorted(i + 1 for i, s in enumerate(lines) if "# " in s
                    and s.rstrip().split("# ")[-1].isdigit())
    assert sorted(f.line for f in res.findings) == marked
    msgs = " | ".join(f.message for f in res.findings)
    for what in (".item()", ".cpu()", ".tolist()", ".numpy()", "float()",
                 "int()", "bool()", "synchronize", "np.asarray"):
        assert what in msgs, what


def test_torch_host_sync_good_is_silent(tmp_path):
    path = _write(tmp_path, "hot.py", GOOD_TORCH)
    res = run_analysis(AnalysisContext(root=tmp_path, files=(path,)),
                       rule_names=["host-sync-in-hot-path"])
    assert res.findings == [], [f.render() for f in res.findings]
    # the noqa'd packed copy is recorded as suppressed, twice on its line
    assert [f.line for f in res.suppressed] == [7, 7]


def test_hot_names_come_from_the_port_variable_only(tmp_path, monkeypatch):
    path = _write(tmp_path, "cold.py", "def my_loop(x):\n    return x.item()\n")
    monkeypatch.setenv("REPRO_LINT_HOT", "my_loop")
    ctx = default_context(tmp_path, paths=[path])
    assert run_analysis(ctx, ["host-sync-in-hot-path"]).findings == []
    monkeypatch.setenv("REPRO_TORCH_LINT_HOT", "my_loop")
    ctx = default_context(tmp_path, paths=[path])
    assert len(run_analysis(ctx, ["host-sync-in-hot-path"]).findings) == 1


def test_noqa_suppresses_only_annotated_line(tmp_path):
    path = _write(tmp_path, "hot.py",
                  "import torch\n"
                  "def decode_tick(x, y):\n"
                  "    a = x.item()  # repro: noqa[host-sync-in-hot-path] why\n"
                  "    b = y.item()\n"
                  "    c = y.cpu()  # repro: noqa[sharding-axis]\n"
                  "    return a, b, c\n")
    res = run_analysis(AnalysisContext(root=tmp_path, files=(path,)),
                       rule_names=["host-sync-in-hot-path"])
    assert [f.line for f in res.suppressed] == [3]
    assert [f.line for f in res.findings] == [4, 5]   # noqa is rule-specific


def test_baseline_is_count_matched_and_line_drift_tolerant(tmp_path):
    ctx = AnalysisContext(root=FIXTURES,
                          files=(FIXTURES / "sharding_axis_bad.py",))
    res = run_analysis(ctx, ["sharding-axis"])
    path = tmp_path / "baseline.json"
    write_baseline(path, res.findings)
    base = load_baseline(path)
    fresh, absorbed = apply_baseline(res.findings, base)
    assert fresh == [] and absorbed == len(res.findings) == 3
    shifted = [Finding(f.path, f.line + 7, f.col, f.rule, f.message)
               for f in res.findings]
    assert apply_baseline(shifted, base) == ([], 3)
    extra = Finding(shifted[0].path, 99, 0, shifted[0].rule,
                    shifted[0].message)
    fresh, _ = apply_baseline(shifted + [extra], base)
    assert fresh == [extra]
    # the same file format as the reference's
    assert ref_analysis.load_baseline(path) == base


def test_port_tree_clean_modulo_its_baseline():
    ctx = default_context(REPO)
    assert len(ctx.files) > 60
    assert all("repro_torch" in f.parts for f in ctx.files)
    assert None not in (ctx.hints_path, ctx.models_dir, ctx.fleet_path,
                        ctx.launch_dir, ctx.knobs_md)
    res = run_analysis(ctx)
    fresh, _ = apply_baseline(
        res.findings, load_baseline(REPO / "tools" /
                                    "analysis_baseline_torch.json"))
    assert fresh == [], "\n".join(f.render() for f in fresh)
    # the by-design host copies are marked, not grandfathered
    assert len(res.suppressed) >= 3


def test_knob_doc_covers_every_port_launcher_flag(tmp_path):
    ctx = default_context(REPO)
    assert run_analysis(ctx, ["knob-doc-drift"]).findings == []
    doc = tmp_path / "knobs.md"
    doc.write_text(ctx.knobs_md.read_text().replace("`--chaos`", "chaos"))
    ctx.knobs_md = doc
    res = run_analysis(ctx, ["knob-doc-drift"])
    assert [f.message.split()[2] for f in res.findings] == ["--chaos"]


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *argv], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=120)


def test_cli_exit_codes_and_json(tmp_path):
    bad = _write(tmp_path, "hot.py", BAD_TORCH)
    out = tmp_path / "findings.json"
    res = _cli(str(bad), "--root", str(tmp_path), "--json", str(out))
    assert res.returncode == 1, res.stdout + res.stderr
    payload = json.loads(out.read_text())
    assert len(payload["findings"]) == 10
    good = _write(tmp_path, "ok.py", GOOD_TORCH)
    res = _cli(str(good), "--root", str(tmp_path))
    assert res.returncode == 0, res.stdout + res.stderr
    res = _cli(str(good), "--root", str(tmp_path), "--rules", "no-such-rule")
    assert res.returncode == 2
    res = _cli("src/repro_torch", "--baseline",
               "tools/analysis_baseline_torch.json")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[repro_torch.analysis] OK" in res.stdout
