"""The readers of the merge drain's inner spans (``owner_apply_host_ms``,
``owner_applies_per_drain``) on a hand-built record, and their silence
where the program opens no "owner-apply" span: a program without the
spans, the escrow regime's drains, or a run on the CPU, where the
executor opens none."""

import json
from types import SimpleNamespace

import pytest

from portbench import run
from portbench.tests.tiny import tiny

NEW = ("owner_apply_host_ms", "owner_applies_per_drain")


def _reads(spans):
    return {n: run._load(run.BENCH / "metrics" / f"{n}.py", n).read(
        SimpleNamespace(spans=spans)) for n in NEW}


SPANS = {"megastep": (16, 0.12), "outbox-drain": (16, 0.056),
         "outbox-gather": (16, 0.004)}


@pytest.mark.parametrize("shards", [1, 4])
def test_readers_on_a_hand_built_record(shards):
    """An ``owner-apply`` an owner a drain: the count over the drains is
    the shard count, the host seconds over the drains in milliseconds."""
    got = _reads(dict(SPANS, **{"owner-apply": (16 * shards,
                                                0.003 * shards)}))
    assert got == pytest.approx({"owner_apply_host_ms": 0.1875 * shards,
                                 "owner_applies_per_drain": float(shards)})


@pytest.mark.parametrize("spans", [
    {}, SPANS, {"owner-apply": (4, 0.01)},
    {"owner-apply": (4, 0.01), "share-refresh": (4, 0.02)}],
    ids=["none", "no-owner-apply", "no-drain", "escrow-drains"])
def test_readers_are_silent_without_their_spans(spans):
    assert _reads(spans) == dict.fromkeys(NEW)


def test_cpu_run_reports_neither(capsys):
    """A traced run of the four-shard cell on the CPU: the executor opens
    only its loop's spans there, so the line leaves the new metrics out
    and the run is correct."""
    rc = run.main(["--workload", "merge.r4.neworder", "--seed",
                   "2147483661", "--seconds", "0.01", "--trace", "1"],
                  device="cpu", overrides=tiny)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert "drain_host_ms" in line["metrics"]
    assert not set(NEW) & set(line["metrics"])
