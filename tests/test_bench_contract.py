"""Output contract of bench.py: the FINAL stdout line is the headline
JSON (printed first, then re-printed after the secondary rows), and a
child that produces nothing still ends the output with a parseable
failure line that carries no old numbers.  These tests drive bench.main()
with a fake measurement child, so the contract is checked on every CPU
test run.

Reference anchor for the metric-output contract: the reference's only
perf output is dbg!(timer.elapsed()) (fft_wgpu src/examples/basic.rs:129).
"""

import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402


class _FakeProc:
    def __init__(self, stdout_lines):
        self.pid = 999999999  # killpg will ENOSRCH harmlessly if called
        self.stdout = io.StringIO("".join(stdout_lines))

    def wait(self):
        return 0


def _run_main(monkeypatch, capsys, child_lines, env=None):
    # bench.main imports subprocess locally; patch the cached module
    import subprocess as sp

    monkeypatch.setattr(sp, "Popen", lambda *a, **k: _FakeProc(child_lines))
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    bench.main()
    return capsys.readouterr().out


def test_final_stdout_line_is_headline_json(monkeypatch, capsys):
    headline = json.dumps(
        {"metric": "m", "value": 1.0, "unit": "GFLOP/s", "vs_baseline": 0.5}
    )
    out = _run_main(
        monkeypatch,
        capsys,
        [headline + "\n", "# secondary row 1\n", "# secondary row 2\n"],
    )
    lines = [ln for ln in out.splitlines() if ln.strip()]
    parsed = json.loads(lines[-1])
    assert parsed["metric"] == "m"
    assert parsed["vs_baseline"] == 0.5
    # first line is ALSO the headline (fast-print hang contract preserved)
    assert json.loads(lines[0]) == parsed


def test_failure_path_final_line_parses(monkeypatch, capsys):
    # child produced nothing: parent must still end with parseable JSON
    out = _run_main(
        monkeypatch, capsys, [], env={"BENCH_HEADLINE_TIMEOUT": "0.2"}
    )
    lines = [ln for ln in out.splitlines() if ln.strip()]
    parsed = json.loads(lines[-1])
    assert "error" in parsed
    assert parsed["vs_baseline"] == 0.0
    assert "last_measured" not in parsed  # no stale numbers reported
