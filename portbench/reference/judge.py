"""The comparison that decides ``correct`` for a TPC-C pass.

The program's tables after the judged pass are compared with the
reference's column by column, entry by entry (floats by their bits), the
order tables on the slots the pass can write and, past them, against the
initial tables; the pass's counters with the reference's; the escrow's
shares and spent after the pass; the guarantee the strict deployments
state, no stock cell below zero; and the counters of the window's other
passes, which all replay one instance, with one another. Each number is a
count of disagreements, held to the limit 0: the program and the
reference do the same integer and float32 operations in the same order,
so they agree to the bit (``PERF.md`` gives the readings the limits were
set from).
"""

from __future__ import annotations

import numpy as np

from .tpcc_np import COUNTERS

LIMITS = {"table_mismatch": 0, "tail_mismatch": 0, "counter_mismatch": 0,
          "pass_disagreement": 0, "escrow_mismatch": 0, "negative_stock": 0}


def _differ(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    if a.dtype == np.float32 or b.dtype == np.float32:
        a = np.ascontiguousarray(a, np.float32).view(np.int32)
        b = np.ascontiguousarray(b, np.float32).view(np.int32)
    return int(np.count_nonzero(a != b))


def judge(ref, program: dict, escrow: bool) -> dict:
    """``program``: ``tables`` (the compared region of each column, order
    columns cut to the reference's), ``tail`` (entries past them that are
    not at their initial value), ``counters`` (a dict a pass the reference
    replayed), optionally ``instance_passes`` (the counters of the passes
    that replay one instance), ``shares`` and ``spent``. Returns each
    number compared."""
    tables = program["tables"]
    table_mismatch = sum(_differ(ref.tables[k], tables.get(k))
                         if k in tables else np.asarray(ref.tables[k]).size
                         for k in ref.tables)
    counter_mismatch = sum(abs(int(p.get(k, 0)) - int(ref.counters[k]))
                           for p in program["counters"] for k in COUNTERS)
    out = {"table_mismatch": table_mismatch,
           "tail_mismatch": int(program["tail"]),
           "counter_mismatch": counter_mismatch}
    if "instance_passes" in program:
        first, *rest = program["instance_passes"]
        out["pass_disagreement"] = sum(p != first for p in rest)
    if escrow:
        out["escrow_mismatch"] = (_differ(ref.shares, program["shares"])
                                  + _differ(ref.spent, program["spent"]))
        out["negative_stock"] = int(np.count_nonzero(
            np.asarray(tables["s_quantity"]) < 0))
    return out


def verdict(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())
