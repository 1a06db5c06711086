"""The readers of the executor's call spans (``captures_per_call``,
``cache_release_ms``, ``graph_record_ms``) on a hand-built record: 0
where the calls capture nothing (graphs kept across calls), and silence
where the program opens no "call-setup" span: a program without the
spans, or a run on the CPU, where the executor opens none."""

import json
from types import SimpleNamespace

import pytest

from portbench import run
from portbench.tests.tiny import tiny

NEW = ("captures_per_call", "cache_release_ms", "graph_record_ms")


def _reader(name):
    return run._load(run.BENCH / "metrics" / f"{name}.py", name)


def _reads(spans):
    return {n: _reader(n).read(SimpleNamespace(spans=spans)) for n in NEW}


SPANS = {"call-setup": (4, 0.4), "capture": (4, 0.3),
         "cache-release": (4, 0.1), "graph-record": (4, 0.16),
         "megastep": (8, 0.01), "outbox-drain": (8, 0.06)}


def test_readers_on_a_hand_built_record():
    got = _reads(SPANS)
    assert got == pytest.approx({"captures_per_call": 1.0,
                                 "cache_release_ms": 25.0,
                                 "graph_record_ms": 40.0})
    two = _reads(dict(SPANS, capture=(8, 0.6), **{
        "cache-release": (8, 0.2), "graph-record": (8, 0.32)}))
    assert two == pytest.approx({"captures_per_call": 2.0,
                                 "cache_release_ms": 50.0,
                                 "graph_record_ms": 80.0})


@pytest.mark.parametrize("missing", [
    ("capture",), ("cache-release",), ("graph-record",),
    ("capture", "cache-release", "graph-record")])
def test_readers_read_zero_without_a_capture(missing):
    """Calls that capture nothing still open "call-setup": each reader of
    a missing span reads 0, not None, so a change that keeps its graphs
    compares with its parent."""
    got = _reads({k: v for k, v in SPANS.items() if k not in missing})
    of = {"capture": "captures_per_call",
          "cache-release": "cache_release_ms",
          "graph-record": "graph_record_ms"}
    for span, name in of.items():
        assert (got[name] == 0) == (span in missing), (name, got[name])


@pytest.mark.parametrize("spans", [
    {}, {k: v for k, v in SPANS.items() if k != "call-setup"}],
    ids=["none", "no-call-setup"])
def test_readers_are_silent_without_their_spans(spans):
    assert _reads(spans) == dict.fromkeys(NEW)


def test_cpu_run_reports_none_of_them(capsys):
    """A traced run on the CPU: the executor opens only its loop's spans
    there, so the line leaves the new metrics out and the run is
    correct."""
    rc = run.main(["--workload", "escrow.neworder", "--seed", "2147483659",
                   "--seconds", "0.01", "--trace", "1"], device="cpu",
                  overrides=tiny)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert "drain_host_ms" in line["metrics"]
    assert not set(NEW) & set(line["metrics"])
