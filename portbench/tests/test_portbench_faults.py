"""The run with the timed path broken underneath comes out not correct,
once for each fault the cells can have. One shard holds every warehouse,
so the drain exchanges nothing between shards there; the exchange the
escrow cells do have is the share refresh, left out below."""

import pytest
import torch

from repro_torch.txn import tpcc
from repro_torch.txn.engine import Engine
from repro_torch.txn.executor import FusedExecutor

from portbench.tests.tiny import CELLS, drive


def _unchanged(monkeypatch):
    """A chunk that returns its state unchanged."""
    monkeypatch.setattr(FusedExecutor, "_chunk", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    """New-Order on the first half of each batch, the rest left out (its
    outputs padded to the batch's shapes, as nothing downstream checks)."""
    def half(batch):
        n = batch.w.shape[0] // 2
        return type(batch)(*(x[:n] for x in batch))

    def pad(x, n):
        if isinstance(x, tuple):
            return type(x)(*(pad(y, n) for y in x))
        return torch.cat([x, x[:n - x.shape[0]]])

    merge, escrow = Engine.neworder_step, Engine.neworder_escrow_step

    def merge_half(self, s, b):
        st, delta, total = merge(self, s, half(b))
        B = b.w.shape[0]
        return st, pad(delta, B * b.i_id.shape[1]), pad(total, B)

    def escrow_half(self, s, e, b):
        st, es, delta, total, ok = escrow(self, s, e, half(b))
        B = b.w.shape[0]
        return (st, es, pad(delta, B * b.i_id.shape[1]), pad(total, B),
                pad(ok, B))
    monkeypatch.setattr(Engine, "neworder_step", merge_half)
    monkeypatch.setattr(Engine, "neworder_escrow_step", escrow_half)


def _no_refresh(monkeypatch):
    """The escrow's share refresh (its one exchange) left out."""
    monkeypatch.setattr(Engine, "refresh_escrow",
                        lambda self, state, esc, alive=None: esc)


def _altered(monkeypatch):
    """One order line's amount altered where New-Order produces it."""
    insert = tpcc._insert_order_rows

    def altered(state, batch, scale, wl, o_id, keep, line_valid, ramp_ts,
                amount, ol_ts):
        amount = amount.clone()
        amount.view(-1)[0] += 0.25
        return insert(state, batch, scale, wl, o_id, keep, line_valid,
                      ramp_ts, amount, ol_ts)
    monkeypatch.setattr(tpcc, "_insert_order_rows", altered)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "no_refresh": _no_refresh, "altered": _altered}


# the merge regime has no share refresh
CASES = [(w, f) for w in CELLS for f in FAULTS
         if f != "no_refresh" or w.startswith("escrow")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    rec = drive(workload, 21)
    assert rec.correct is False, rec.checks
