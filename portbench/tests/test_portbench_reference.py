"""The reference against the port's eager CPU path, at a tiny size, in
both regimes and every cell's mix: the judge finds no difference."""

import json

import numpy as np
import pytest

from portbench import run
from portbench.tests.tiny import CELLS, drive, tiny


@pytest.mark.parametrize("seed", [3, 2**31 + 5, -7])
@pytest.mark.parametrize("workload", CELLS)
def test_port_matches_reference(workload, seed):
    rec = drive(workload, seed)
    assert rec.correct, rec.checks
    assert set(rec.checks) >= {"table_mismatch", "tail_mismatch",
                               "counter_mismatch", "pass_disagreement"}
    ref = rec.reference.counters
    assert rec.pass_counters[-1]["neworders"] == ref["neworders"] > 0


def test_escrow_cells_abort_and_mix_reads():
    """The tiny escrow cell sells out (aborts are compared, not absent);
    the mix's reads find orders, as every customer has one from the
    initial population, and Delivery delivers an initial order in every
    district each step."""
    assert drive("escrow.neworder", 11).reference.counters["aborts"] > 0
    rec = drive("merge.mix", 11)
    ref = rec.reference.counters
    assert ref["reads_found"] == ref["order_statuses"] > 0
    assert ref["payments"] > 0
    assert ref["deliveries"] == 6 * 3 * 2      # steps x warehouses x districts
    assert rec.pass_counters[-1]["reads_found"] == ref["reads_found"]


def test_initial_orders():
    """Clause 4.3.3.1's population: an order a customer in every district,
    the last 30% undelivered with their amounts, the rest delivered."""
    rec = drive("merge.neworder", 4)
    t = rec.program["tables"]
    C = t["c_balance"].shape[2]
    N, new = C, C * 3 // 10
    assert (np.sort(t["o_c_id"][:, :, :N], 2) == np.arange(C)).all()
    assert t["no_valid"][:, :, :N].sum(2).tolist() == [[new] * 2] * 3
    assert (t["o_carrier"][:, :, :N - new] >= 1).all()
    lines = t["ol_valid"][:, :, :N]
    assert (lines.sum(3) == t["o_ol_cnt"][:, :, :N]).all()
    assert (t["ol_amount"][:, :, N - new:N][lines[:, :, N - new:]] > 0).all()
    assert (t["ol_amount"][:, :, :N - new] == 0).all()


def test_run_prints_result_last(capsys):
    rc = run.main(["--workload", "escrow.uniform", "--seed", "9",
                   "--seconds", "0.01", "--trace", "0"], device="cpu",
                  overrides=tiny)
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert set(line["metrics"]) == {"neworder_tps", "setup_s"}
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") and " limit " in s for s in last)


def test_run_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "merge.neworder", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("workload", CELLS)
def test_seeds_relabel_the_timed_passes(workload):
    """Every seed times the instance under new names (the same counters,
    other layouts) and judges a pass drawn from the seed."""
    a, b = drive(workload, 101), drive(workload, 202)
    assert a.pass_counters[0] == b.pass_counters[0]
    assert not all(
        (a.program["tables"][k] == b.program["tables"][k]).all()
        for k in ("s_quantity", "o_c_id"))
    assert a.reference.tables["ol_i_id"].shape[2] >= 16
    assert not np.array_equal(a.reference.tables["ol_qty"],
                              b.reference.tables["ol_qty"])


def test_window_is_a_fixed_count_of_passes():
    """A window's passes follow from ``--seconds`` and the traffic's
    ``pass_seconds`` alone, so two runs of one seed attempt and fail the
    same transactions however fast each ran."""
    a, b = (drive("escrow.neworder", 13, seconds=0.6) for _ in range(2))
    assert a.instance_passes == b.instance_passes == 2
    assert len(a.pass_counters) == 3
    assert (a.attempted, a.failed) == (b.attempted, b.failed)
    assert a.failed > 0
