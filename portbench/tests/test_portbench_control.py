"""The control: the reference, computed in bfloat16 (the precision below
the tables' float32) and put in the program's place, comes out as not
correct in every cell; the float32 reference against itself comes out
correct."""

import pytest

from portbench.reference import judge
from portbench.tests.tiny import CELLS, cell, driver


def _as_program(res):
    return dict(tables=res.tables, tail=0, counters=[res.counters],
                shares=res.shares, spent=res.spent)


def _replay(workload, seed, precision):
    cfg, traffic = cell(workload)
    mod = driver(cfg)
    judged, initial = mod.initial_tables(cfg, traffic, seed, "cpu")
    return cfg, mod.replay(cfg, traffic, initial, judged, precision)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cfg, ref = _replay(workload, 5, "float32")
    _, low = _replay(workload, 5, "bfloat16")
    escrow = cfg["regime"] == "escrow"
    numbers = judge.judge(ref, _as_program(low), escrow)
    assert numbers["table_mismatch"] > 0
    assert not judge.verdict(numbers)
    same = judge.judge(ref, _as_program(ref), escrow)
    assert judge.verdict(same), same
